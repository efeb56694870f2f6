"""The client's telemetry: the process's registry of requests, and the
trace context that joins a client's request to the server's record of it.

The port's copy of ``triton_client_tpu/_telemetry.py``:

* :class:`LatencyHistogram`, log-bucketed (5% per bucket from 1 us to
  ~130 s): quantiles to ~2.5% without keeping samples, one lock and two
  adds per observation.  ``perf_analyzer`` records every latency in one,
  the server's flight recorder keeps one per model.
* :class:`ClientTelemetry`, the registry :func:`telemetry` returns: per
  (model, protocol, method) successes, failures, retries, request and
  response bytes and a latency histogram, and the shared-memory register
  and transfer counters, and the cluster client's series: requests per
  endpoint and outcome, each endpoint's breaker state, hedges issued and
  won per (model, protocol).  Both clients record every request in it
  (``record_request``; ``infer_many`` one flight at a time,
  ``record_request_batch``).  A request hook sees every record and never
  fails a request.  ``render_prometheus`` gives the ``nv_client_*``
  families, ``snapshot`` the same as JSON (``perf_analyzer
  --export-metrics``).
* Client tracing: with ``enable_tracing(path)`` (JSON Lines) or
  ``enable_otlp(endpoint)`` each request writes its REQUEST, SERIALIZE,
  NETWORK and DESERIALIZE spans (``record_infer_spans``) under the
  traceparent it sent.
* Trace context: :func:`new_trace_context` gives a request's
  ``traceparent`` and ``triton-request-id``, which the server records in
  its trace and echoes back.  Inside a journey (:func:`begin_journey`, the
  retry layer's scope around its attempts) every attempt shares the
  journey's trace id and takes a span id of its own; the cluster client
  drops zero-length events on it (``ENDPOINT_SWITCH``, ``BREAKER_OPEN``,
  :meth:`ClientTelemetry.record_journey_event`).

``AppendFile`` is the cached append handle of this module's trace file,
the server's request tracer and its log; ``escape_label`` the Prometheus
label escape.

A package rather than a ``_telemetry.py`` file: the repository's lint
(``triton-lint``'s METRICS-DECL) reads the one file of that name as the
reference's client metrics registry.
"""

from __future__ import annotations

import contextvars
import json
import math
import os
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

#: the correlation id header (the server echoes it on the response)
REQUEST_ID_HEADER = "triton-request-id"
#: the W3C Trace Context header stamped beside it
#: (00-<trace 16 bytes>-<span 8 bytes>-01)
TRACEPARENT_HEADER = "traceparent"
#: a collector endpoint here arms the client's OTLP export at import
OTLP_ENDPOINT_ENV = "TRITON_TPU_OTLP_ENDPOINT"

#: ``nv_client_endpoint_state``'s value of each breaker state
ENDPOINT_STATE_CODES = {"closed": 0, "open": 1, "half_open": 2}

# a header-safe id: visible ASCII; another id stays in the body only
_HEADER_SAFE = re.compile(r"[\x20-\x7e]+\Z")


def _safe_id(request_id: str) -> str:
    """``request_id`` where it can travel as a header, else a fresh id."""
    if request_id and _HEADER_SAFE.match(request_id):
        return request_id
    return os.urandom(8).hex()


class Journey:
    """One logical request across its attempts: one trace id for all of
    them, the attempt number the retry loop is on, and the traceparent of
    the latest attempt."""

    __slots__ = ("trace_id", "request_id", "attempt", "traceparent")

    def __init__(self, trace_id: str, request_id: str) -> None:
        self.trace_id = trace_id
        self.request_id = request_id
        self.attempt = 0
        self.traceparent = ""


_JOURNEY: contextvars.ContextVar[Optional[Journey]] = \
    contextvars.ContextVar("tc_torch_journey", default=None)


def begin_journey(request_id: str = ""):
    """Open a journey in this context; returns the scope to give
    :func:`end_journey`, or None where one is open already (an inner retry
    loop must not start a second trace id)."""
    if _JOURNEY.get() is not None:
        return None
    journey = Journey(os.urandom(16).hex(), _safe_id(request_id))
    return journey, _JOURNEY.set(journey)


def end_journey(scope) -> None:
    """Close the scope :func:`begin_journey` returned."""
    _JOURNEY.reset(scope[1])


def current_journey() -> Optional[Journey]:
    return _JOURNEY.get()


def new_trace_context(request_id: str = "") -> Dict[str, str]:
    """Fresh propagation headers for one request: ``request_id`` is the
    correlation id where it is header-safe, else one is minted.  Inside a
    journey the trace id and the correlation id are the journey's and only
    the span id is new."""
    journey = _JOURNEY.get()
    span = os.urandom(8).hex()
    if journey is not None:
        traceparent = f"00-{journey.trace_id}-{span}-01"
        journey.traceparent = traceparent
        rid = (request_id if request_id and _HEADER_SAFE.match(request_id)
               else journey.request_id)
        return {REQUEST_ID_HEADER: rid, TRACEPARENT_HEADER: traceparent}
    return {REQUEST_ID_HEADER: _safe_id(request_id),
            TRACEPARENT_HEADER: f"00-{os.urandom(16).hex()}-{span}-01"}


def merge_trace_headers(headers: Optional[Dict[str, str]],
                        request_id: str = "") -> Tuple[Dict[str, str], str]:
    """The trace headers to add to one HTTP request (a fresh context less
    the keys the caller sets itself, whose values win), and the
    correlation id the request carries."""
    ctx = new_trace_context(request_id)
    user = {k.lower(): v for k, v in headers.items()} if headers else {}
    extra = {k: v for k, v in ctx.items() if k not in user}
    return extra, user.get(REQUEST_ID_HEADER, ctx[REQUEST_ID_HEADER])


def traceparent_on_wire(user_headers: Optional[Dict[str, str]],
                        minted_headers: Dict[str, str]) -> str:
    """The traceparent one HTTP request sent: the caller's where it set
    one, else the minted one."""
    for k, v in (user_headers or {}).items():
        if k.lower() == TRACEPARENT_HEADER:
            return v
    return minted_headers.get(TRACEPARENT_HEADER, "")


def traceparent_from_metadata(metadata) -> str:
    """The traceparent of gRPC metadata as ``(key, value)`` pairs."""
    return next((v for k, v in metadata
                 if k.lower() == TRACEPARENT_HEADER), "")


def escape_label(value: str) -> str:
    """A label value escaped per the Prometheus text exposition format
    (backslash, double quote, newline)."""
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


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

    @property
    def sum_s(self) -> float:
        return self._sum_s

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

    def snapshot_us(self) -> Dict[str, Any]:
        """count, mean, p50, p90 and p99 in microseconds; None (JSON null,
        never NaN) where empty, so a snapshot stays strict JSON."""
        if not self.count:
            return {"count": 0, "avg_us": None, "p50_us": None,
                    "p90_us": None, "p99_us": None}
        return {"count": self.count, "avg_us": self.mean() * 1e6,
                "p50_us": self.quantile(0.50) * 1e6,
                "p90_us": self.quantile(0.90) * 1e6,
                "p99_us": self.quantile(0.99) * 1e6}


class _RequestSeries:
    __slots__ = ("success", "failure", "retries", "request_bytes",
                 "response_bytes", "latency")

    def __init__(self) -> None:
        self.success = 0
        self.failure = 0
        self.retries = 0
        self.request_bytes = 0
        self.response_bytes = 0
        self.latency = LatencyHistogram()


#: a request outcome as ``record_request_batch`` takes it:
#: (ok, latency_s or None, request bytes, response bytes, request id)
Outcome = Tuple[bool, Optional[float], int, int, str]


class ClientTelemetry:
    """The process's client registry.

    A series is keyed (model, protocol, method): ``protocol`` is ``http``
    or ``grpc``, ``method`` ``infer``, ``async_infer`` or
    ``stream_infer``.  A ``stream_infer`` counts its sends (the answer
    comes on the stream's callback) and observes no latency."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._requests: Dict[Tuple[str, str, str], _RequestSeries] = {}
        # (protocol, kind) -> [registrations, bytes]; kind system | cuda
        self._shm_register: Dict[Tuple[str, str], List[int]] = {}
        # (kind, direction) -> [transfers, bytes]; direction write | read
        self._shm_transfer: Dict[Tuple[str, str], List[int]] = {}
        # the cluster client's: (endpoint, success | failure) -> requests,
        # endpoint -> breaker state, (model, protocol) -> [hedges, wins]
        self._endpoint_requests: Dict[Tuple[str, str], int] = {}
        self._endpoint_state: Dict[str, str] = {}
        self._hedges: Dict[Tuple[str, str], List[int]] = {}
        self._hook: Optional[Callable[[Dict[str, Any]], None]] = None
        # client tracing: a JSON Lines file and/or an OTLP exporter
        self._trace_path: Optional[str] = None
        self._trace_lock = threading.Lock()
        self._trace_out = AppendFile()
        self._otlp = None
        endpoint = os.environ.get(OTLP_ENDPOINT_ENV, "").strip()
        if endpoint:
            try:
                self.enable_otlp(endpoint)
            except ValueError:
                pass  # a malformed variable must not break an import

    # -- recording -----------------------------------------------------------
    def _series(self, key: Tuple[str, str, str]) -> _RequestSeries:
        s = self._requests.get(key)
        if s is None:
            with self._lock:
                s = self._requests.setdefault(key, _RequestSeries())
        return s

    @staticmethod
    def _count(s: _RequestSeries, ok: bool, latency_s: Optional[float],
               request_bytes: int, response_bytes: int) -> None:
        """One request's counters and observation; the caller holds
        ``s.latency._lock`` (one lock per request, or per flight)."""
        h = s.latency
        if ok:
            s.success += 1
        else:
            s.failure += 1
        s.request_bytes += request_bytes
        s.response_bytes += response_bytes
        if latency_s is not None:
            h._counts[h._index(latency_s)] += 1
            h._count += 1
            h._sum_s += latency_s

    def _call_hook(self, model: str, protocol: str, method: str,
                   outcome: Outcome, ts: float) -> None:
        hook = self._hook
        if hook is None:
            return
        ok, latency_s, request_bytes, response_bytes, request_id = outcome
        try:
            hook({"model": model, "protocol": protocol, "method": method,
                  "ok": ok, "latency_s": latency_s,
                  "request_bytes": request_bytes,
                  "response_bytes": response_bytes,
                  "request_id": request_id, "ts": ts})
        except Exception:  # noqa: BLE001 - a hook never fails a request
            pass

    def record_request(self, model: str, protocol: str, method: str,
                       latency_s: Optional[float], ok: bool,
                       request_bytes: int = 0, response_bytes: int = 0,
                       request_id: str = "") -> None:
        """One finished request (``latency_s`` None: counted, not
        observed)."""
        s = self._series((model, protocol, method))
        with s.latency._lock:
            self._count(s, ok, latency_s, request_bytes, response_bytes)
        self._call_hook(model, protocol, method,
                        (ok, latency_s, request_bytes, response_bytes,
                         request_id), time.time())

    def record_request_batch(self, model: str, protocol: str, method: str,
                             outcomes) -> None:
        """The requests of one ``infer_many`` flight, as
        :data:`Outcome` tuples, under one lock: every counter still moves
        once per request."""
        outcomes = list(outcomes)
        if not outcomes:
            return
        s = self._series((model, protocol, method))
        with s.latency._lock:
            for ok, latency_s, req_b, resp_b, _rid in outcomes:
                self._count(s, ok, latency_s, req_b, resp_b)
        now = time.time()
        for outcome in outcomes:
            self._call_hook(model, protocol, method, outcome, now)

    def record_retry(self, model: str, protocol: str, method: str) -> None:
        """One retried attempt, counted when the retry is committed (a
        retry that then succeeds counts too)."""
        s = self._series((model, protocol, method))
        with s.latency._lock:
            s.retries += 1

    def record_shm_register(self, protocol: str, kind: str,
                            byte_size: int) -> None:
        with self._lock:
            c = self._shm_register.setdefault((protocol, kind), [0, 0])
            c[0] += 1
            c[1] += int(byte_size)

    def record_shm_transfer(self, kind: str, direction: str,
                            nbytes: int) -> None:
        with self._lock:
            c = self._shm_transfer.setdefault((kind, direction), [0, 0])
            c[0] += 1
            c[1] += int(nbytes)

    # -- the cluster client ------------------------------------------------
    def record_endpoint_request(self, endpoint: str, ok: bool) -> None:
        """One request the cluster client routed to ``endpoint``
        (``nv_client_endpoint_requests_total``)."""
        key = (endpoint, "success" if ok else "failure")
        with self._lock:
            self._endpoint_requests[key] = \
                self._endpoint_requests.get(key, 0) + 1

    def set_endpoint_state(self, endpoint: str, state: str) -> None:
        """An endpoint's breaker state, ``closed``, ``open`` or
        ``half_open`` (``nv_client_endpoint_state``, 0 / 1 / 2).  An open
        breaker drops a ``BREAKER_OPEN`` event on the journey in progress:
        it explains the endpoint switch that follows."""
        with self._lock:
            self._endpoint_state[endpoint] = state
        if state == "open":
            self.record_journey_event("BREAKER_OPEN", endpoint=endpoint,
                                      ok=False)

    def record_hedge(self, model: str, protocol: str,
                     won: bool = False) -> None:
        """One hedge issued (``won`` False), or one hedge that answered
        before its primary (``won`` True): ``nv_client_hedges_total`` and
        ``nv_client_hedge_wins_total``."""
        with self._lock:
            c = self._hedges.setdefault((model, protocol), [0, 0])
            c[1 if won else 0] += 1

    # -- client tracing ----------------------------------------------------
    def enable_tracing(self, path: str) -> None:
        """Write each request's client spans to ``path`` (JSON Lines), with
        the ``triton-request-id`` and ``traceparent`` it sent: the join key
        with the server's trace file."""
        with self._trace_lock:
            self._trace_path = path

    def disable_tracing(self) -> None:
        with self._trace_lock:
            self._trace_path = None
            self._trace_out.close()

    def enable_otlp(self, endpoint: str):
        """Export client records to an OTLP/HTTP collector (``host:4318``
        or a URL), with or without a trace file.  Returns the exporter."""
        from ..otlp import OtlpExporter, encode_client_record

        exporter = OtlpExporter(endpoint, "triton-tpu-client",
                                encode_client_record)
        with self._trace_lock:
            old, self._otlp = self._otlp, exporter
        if old is not None:
            old.shutdown(0.0)
        return exporter

    def disable_otlp(self) -> None:
        with self._trace_lock:
            exporter, self._otlp = self._otlp, None
        if exporter is not None:
            exporter.shutdown()

    @property
    def otlp_exporter(self):
        return self._otlp

    @property
    def tracing_enabled(self) -> bool:
        return self._trace_path is not None or self._otlp is not None

    def record_infer_spans(self, request_id: str, model: str, protocol: str,
                           method: str, start_ns: int, serialize_end_ns: int,
                           network_end_ns: int, traceparent: str = "",
                           ok: bool = True) -> None:
        """One request's spans, ending now: REQUEST over SERIALIZE (the
        body built), NETWORK (the round trip) and DESERIALIZE (the result
        built).  A failed attempt is recorded too (``ok=False``)."""
        end = time.monotonic_ns()
        self.record_client_trace(
            request_id, model, protocol, method,
            spans=[("REQUEST", start_ns, end),
                   ("SERIALIZE", start_ns, serialize_end_ns),
                   ("NETWORK", serialize_end_ns, network_end_ns),
                   ("DESERIALIZE", network_end_ns, end)],
            ok=ok, traceparent=traceparent)

    def record_client_trace(self, request_id: str, model: str,
                            protocol: str, method: str, spans,
                            ok: bool = True, traceparent: str = "",
                            attempt: int = 0, endpoint: str = "") -> None:
        """One client record; ``spans`` are ``(name, start_ns, end_ns)`` on
        this process's monotonic clock.  Inside a journey the record takes
        the attempt number and, where none is given, the journey's
        traceparent."""
        path = self._trace_path
        otlp = self._otlp
        if path is None and otlp is None:
            return
        journey = _JOURNEY.get()
        if journey is not None:
            attempt = attempt or journey.attempt
            traceparent = traceparent or journey.traceparent
        record: Dict[str, Any] = {
            "request_id": request_id, "model": model, "protocol": protocol,
            "method": method, "ok": ok,
            "spans": [{"name": n, "start_ns": int(s), "end_ns": int(e)}
                      for n, s, e in spans],
        }
        if traceparent:
            record["traceparent"] = traceparent
        if attempt:
            record["attempt"] = int(attempt)
        if endpoint:
            record["endpoint"] = endpoint
        if otlp is not None:
            otlp.submit(record)
        if path is None:
            return
        line = json.dumps(record) + "\n"
        with self._trace_lock:
            # a disable_tracing() meanwhile closed the file: do not reopen
            if self._trace_path == path:
                self._trace_out.append(path, line)

    def record_journey_event(self, name: str, model: str = "",
                             protocol: str = "", endpoint: str = "",
                             request_id: str = "", ok: bool = True) -> None:
        """A zero-length event (``ENDPOINT_SWITCH``, ``BREAKER_OPEN``) on
        the journey in progress, attributed to ``endpoint``; nothing where
        tracing is off or no journey is open."""
        if not self.tracing_enabled:
            return
        journey = _JOURNEY.get()
        if journey is None:
            return
        now = time.monotonic_ns()
        self.record_client_trace(
            request_id or journey.request_id, model, protocol, "event",
            spans=[(name, now, now)], ok=ok,
            traceparent=journey.traceparent, endpoint=endpoint)

    # -- the hook ----------------------------------------------------------
    def set_request_hook(
            self, hook: Optional[Callable[[Dict[str, Any]], None]]) -> None:
        """Call ``hook(event)`` after every recorded request (None clears
        it); what it raises is swallowed."""
        self._hook = hook

    # -- what it shows -----------------------------------------------------
    def reset(self) -> None:
        with self._lock:
            self._requests.clear()
            self._shm_register.clear()
            self._shm_transfer.clear()
            self._endpoint_requests.clear()
            self._endpoint_state.clear()
            self._hedges.clear()

    def _copy(self):
        with self._lock:
            # the series objects, not their keys: a reset() meanwhile
            # clears the dict
            return (sorted(self._requests.items()),
                    sorted((k, list(v))
                           for k, v in self._shm_register.items()),
                    sorted((k, list(v))
                           for k, v in self._shm_transfer.items()),
                    dict(sorted(self._endpoint_requests.items())),
                    dict(sorted(self._endpoint_state.items())),
                    sorted((k, list(v)) for k, v in self._hedges.items()))

    def snapshot(self) -> Dict[str, Any]:
        """Every series as JSON (``perf_analyzer --export-metrics``)."""
        series, shm_reg, shm_tx, ep_req, ep_state, hedges = self._copy()
        requests = []
        for (model, protocol, method), s in series:
            entry = {"model": model, "protocol": protocol, "method": method,
                     "success": s.success, "failure": s.failure,
                     "retries": s.retries,
                     "request_bytes": s.request_bytes,
                     "response_bytes": s.response_bytes}
            entry.update(s.latency.snapshot_us())
            requests.append(entry)
        otlp = self._otlp
        return {
            "requests": requests,
            "otlp": otlp.counters() if otlp is not None else None,
            "endpoints": [
                {"endpoint": e, "success": ep_req.get((e, "success"), 0),
                 "failure": ep_req.get((e, "failure"), 0),
                 "state": ep_state.get(e)}
                for e in sorted({e for e, _ in ep_req} | set(ep_state))],
            "hedges": [{"model": m, "protocol": p, "hedges": c[0],
                        "wins": c[1]} for (m, p), c in hedges],
            "shared_memory": {
                "register": [{"protocol": p, "kind": k,
                              "registrations": c[0], "bytes": c[1]}
                             for (p, k), c in shm_reg],
                "transfer": [{"kind": k, "direction": d,
                              "transfers": c[0], "bytes": c[1]}
                             for (k, d), c in shm_tx],
            },
        }

    def render_prometheus(self) -> str:
        """The client's series in the Prometheus text exposition format."""
        series, shm_reg, shm_tx, ep_req, ep_state, hedges = self._copy()
        lines: List[str] = []

        def family(name: str, help_text: str, kind: str,
                   rows: List[str]) -> None:
            if rows:
                lines.extend([f"# HELP {name} {help_text}",
                              f"# TYPE {name} {kind}", *rows])

        def labels(key: Tuple[str, str, str]) -> str:
            return (f'model="{escape_label(key[0])}",'
                    f'protocol="{escape_label(key[1])}",'
                    f'method="{escape_label(key[2])}"')

        for name, help_text, field in (
                ("nv_client_inference_request_success",
                 "Number of successful client inference requests",
                 "success"),
                ("nv_client_inference_request_failure",
                 "Number of failed client inference requests", "failure"),
                ("nv_client_retries_total",
                 "Number of retried client request attempts (resilience "
                 "layer)", "retries"),
                ("nv_client_request_bytes_total",
                 "Cumulative serialized request payload bytes sent",
                 "request_bytes"),
                ("nv_client_response_bytes_total",
                 "Cumulative serialized response payload bytes received",
                 "response_bytes")):
            family(name, help_text, "counter",
                   [f"{name}{{{labels(k)}}} {getattr(s, field)}"
                    for k, s in series])
        name = "nv_client_inference_request_duration_us"
        summary: List[str] = []
        for k, s in series:
            h = s.latency
            if not h.count:
                continue
            for q in ("0.5", "0.9", "0.99"):
                summary.append(f'{name}{{{labels(k)},quantile="{q}"}} '
                               f"{h.quantile(float(q)) * 1e6:.1f}")
            summary.append(f"{name}_sum{{{labels(k)}}} {h.sum_s * 1e6:.1f}")
            summary.append(f"{name}_count{{{labels(k)}}} {h.count}")
        family(name, "Client-observed inference request duration in "
               "microseconds", "summary", summary)
        family("nv_client_endpoint_requests_total",
               "Number of client requests routed to each cluster endpoint",
               "counter",
               [f'nv_client_endpoint_requests_total{{endpoint='
                f'"{escape_label(e)}",outcome="{escape_label(o)}"}} {n}'
                for (e, o), n in ep_req.items()])
        family("nv_client_endpoint_state",
               "Cluster endpoint breaker state (0=closed, 1=open, "
               "2=half_open)", "gauge",
               [f'nv_client_endpoint_state{{endpoint="{escape_label(e)}"}} '
                f"{ENDPOINT_STATE_CODES.get(st, -1)}"
                for e, st in ep_state.items()])
        for name, help_text, i in (
                ("nv_client_hedges_total",
                 "Number of hedged requests issued by the cluster client",
                 0),
                ("nv_client_hedge_wins_total",
                 "Number of hedged requests where the hedge beat the "
                 "primary", 1)):
            family(name, help_text, "counter",
                   [f'{name}{{model="{escape_label(m)}",'
                    f'protocol="{escape_label(p)}"}} {c[i]}'
                    for (m, p), c in hedges])
        family("nv_client_shared_memory_register_total",
               "Number of shared-memory regions registered by this client "
               "process", "counter",
               [f'nv_client_shared_memory_register_total{{protocol='
                f'"{escape_label(p)}",kind="{escape_label(k)}"}} {c[0]}'
                for (p, k), c in shm_reg])
        family("nv_client_shared_memory_register_bytes_total",
               "Cumulative byte size of shared-memory regions registered",
               "counter",
               [f'nv_client_shared_memory_register_bytes_total{{protocol='
                f'"{escape_label(p)}",kind="{escape_label(k)}"}} {c[1]}'
                for (p, k), c in shm_reg])
        family("nv_client_shared_memory_transfer_bytes_total",
               "Cumulative bytes copied into/out of shared-memory regions",
               "counter",
               [f'nv_client_shared_memory_transfer_bytes_total{{kind='
                f'"{escape_label(k)}",direction="{escape_label(d)}"}} '
                f"{c[1]}" for (k, d), c in shm_tx])
        otlp = self._otlp
        if otlp is not None:
            c = otlp.counters()
            family("nv_client_otlp_export_total",
                   "Number of OTLP export batches sent by this client "
                   "process", "counter",
                   [f'nv_client_otlp_export_total{{outcome="ok"}} {c["ok"]}',
                    f'nv_client_otlp_export_total{{outcome="error"}} '
                    f'{c["error"]}'])
            family("nv_client_otlp_dropped_total",
                   "Number of client trace records dropped by the bounded "
                   "OTLP export queue", "counter",
                   [f'nv_client_otlp_dropped_total {c["dropped"]}'])
        return "\n".join(lines) + ("\n" if lines else "")


_TELEMETRY = ClientTelemetry()


def telemetry() -> ClientTelemetry:
    """The process-wide client registry."""
    return _TELEMETRY
