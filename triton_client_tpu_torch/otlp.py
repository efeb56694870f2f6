"""OTLP/HTTP export of trace records as JSON, on the standard library.

The port's copy of ``triton_client_tpu/otlp.py``.  The client
(``_telemetry.ClientTelemetry``) and the server (``server/trace.py``)
write trace records that share one W3C ``traceparent``; this module turns
a record into OTLP spans and posts them to any collector that speaks
OTLP/HTTP JSON (the OpenTelemetry collector, Jaeger, Tempo):

* :func:`encode_client_record` and :func:`encode_server_record` give one
  record's spans in the protobuf JSON mapping: ``traceId`` and ``spanId``
  as 32 and 16 lowercase hex characters, ``*UnixNano`` as decimal strings,
  attribute values wrapped by type.  The spans equal the reference's
  byte for byte once serialized (``tests/test_torch_otlp.py``).
* A span id is derived from the traceparent and the span's place (record
  id, replica, name, index), so the same record encoded twice gives the
  same ids and a collector that receives it twice keeps one trace.
* :class:`OtlpExporter` batches records on a bounded queue and posts them
  from a thread of its own.  ``submit`` takes one lock and never blocks
  nor raises: a full queue counts a drop, a failed post an error
  (``nv_otlp_export_total{outcome}`` and ``nv_otlp_dropped_total`` on the
  server, ``nv_client_otlp_*`` on the client).

Records carry ``time.monotonic_ns()``; an exporter takes one offset from
the monotonic to the Unix clock when it is made and moves every span by
it, so one process's spans keep their order and spacing.
"""

from __future__ import annotations

import hashlib
import json
import re
import threading
import time
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "OTLP_TRACES_PATH",
    "OtlpExporter",
    "derive_span_id",
    "encode_client_record",
    "encode_resource_spans",
    "encode_server_record",
    "normalize_endpoint",
    "split_traceparent",
]

#: the OTLP/HTTP traces path (a collector listens on e.g. :4318/v1/traces)
OTLP_TRACES_PATH = "/v1/traces"

#: SpanKind values (the JSON mapping takes the integers)
SPAN_KIND_INTERNAL = 1
SPAN_KIND_SERVER = 2
SPAN_KIND_CLIENT = 3

_STATUS_ERROR = {"code": 2}  # STATUS_CODE_ERROR

_TRACEPARENT = re.compile(
    r"\A[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}\Z")


def split_traceparent(traceparent: str) -> Optional[Tuple[str, str]]:
    """(trace id, span id) of a W3C traceparent, or None where it is
    malformed or an id is all zeros (invalid by the specification)."""
    m = _TRACEPARENT.match(traceparent or "")
    if m is None or m.group(1) == "0" * 32 or m.group(2) == "0" * 16:
        return None
    return m.group(1), m.group(2)


def _hex_id(length: int, parts) -> str:
    h = hashlib.sha256("|".join(parts).encode()).hexdigest()[:length]
    # an all-zero id is invalid: never return one
    return "1" + h[1:] if h == "0" * length else h


def derive_span_id(*parts: str) -> str:
    """A span id (16 hex characters) derived from the span's place: the
    same parts always give the same id."""
    return _hex_id(16, parts)


def _derive_trace_id(*parts: str) -> str:
    return _hex_id(32, parts)


def _attr(key: str, value: Any) -> Dict[str, Any]:
    if isinstance(value, bool):
        v: Dict[str, Any] = {"boolValue": value}
    elif isinstance(value, int):
        v = {"intValue": str(value)}  # int64 is a string in the mapping
    elif isinstance(value, float):
        v = {"doubleValue": value}
    else:
        v = {"stringValue": str(value)}
    return {"key": key, "value": v}


def _span(trace_id: str, span_id: str, name: str, kind: int,
          start_unix_ns: int, end_unix_ns: int,
          parent_span_id: str = "", attributes: Optional[List[dict]] = None,
          error: bool = False) -> Dict[str, Any]:
    span: Dict[str, Any] = {
        "traceId": trace_id,
        "spanId": span_id,
        "name": name,
        "kind": kind,
        "startTimeUnixNano": str(int(start_unix_ns)),
        "endTimeUnixNano": str(int(end_unix_ns)),
    }
    if parent_span_id:
        span["parentSpanId"] = parent_span_id
    if attributes:
        span["attributes"] = attributes
    if error:
        span["status"] = _STATUS_ERROR
    return span


def encode_client_record(record: Dict[str, Any],
                         clock_offset_ns: int = 0) -> List[Dict[str, Any]]:
    """One client record (``ClientTelemetry.record_client_trace``) as
    spans.  Its REQUEST span takes the traceparent's span id, the id the
    server's root span names as its parent, so the collector joins the
    client's attempt and the server's work in one tree; the other spans
    are its children."""
    ids = split_traceparent(record.get("traceparent", ""))
    if ids is None:
        trace_id = _derive_trace_id("client", str(record.get("request_id")))
        root_id = derive_span_id(trace_id, "client-root")
    else:
        trace_id, root_id = ids
    attrs = [_attr("model", record.get("model", "")),
             _attr("protocol", record.get("protocol", "")),
             _attr("method", record.get("method", ""))]
    if record.get("attempt"):
        attrs.append(_attr("attempt", int(record["attempt"])))
    if record.get("endpoint"):
        attrs.append(_attr("endpoint", record["endpoint"]))
    if record.get("request_id"):
        attrs.append(_attr("triton.request_id", record["request_id"]))
    error = not record.get("ok", True)
    spans: List[Dict[str, Any]] = []
    for i, s in enumerate(record.get("spans", ())):
        name = s.get("name", "")
        start = int(s.get("start_ns", 0)) + clock_offset_ns
        end = int(s.get("end_ns", 0)) + clock_offset_ns
        if name == "REQUEST":
            spans.append(_span(
                trace_id, root_id,
                "client " + str(record.get("method") or "infer"),
                SPAN_KIND_CLIENT, start, end, attributes=attrs, error=error))
        else:
            spans.append(_span(
                trace_id, derive_span_id(trace_id, root_id, name, str(i)),
                name, SPAN_KIND_INTERNAL, start, end, parent_span_id=root_id,
                attributes=attrs, error=error))
    return spans


def _server_attrs(record: Dict[str, Any], replica: str) -> List[dict]:
    attrs = [_attr("model", record.get("model_name", ""))]
    optional = (("model_version", "model_version"), ("replica", None),
                ("triton.request_id", "triton_request_id"),
                ("tenant", "tenant"), ("outcome", "outcome"),
                ("shed_reason", "shed_reason"), ("status", "status"))
    for key, field in optional:
        value = replica if field is None else record.get(field)
        if value:
            attrs.append(_attr(key, str(value) if key in (
                "model_version", "status") else value))
    return attrs


def encode_server_record(record: Dict[str, Any],
                         clock_offset_ns: int = 0) -> List[Dict[str, Any]]:
    """One server record (``RequestTracer``'s, a refusal's too) as spans.
    Span ids derive from (trace id, replica, record id, name, index); a
    record's root span (no parent) names the traceparent's span id as its
    parent: the client attempt that reached this server."""
    replica = str(record.get("replica", ""))
    rec_id = str(record.get("id", ""))
    ids = split_traceparent(record.get("traceparent", ""))
    if ids is None:
        trace_id = _derive_trace_id(
            "server", replica, rec_id,
            str(record.get("triton_request_id", "")))
        client_span_id = ""
    else:
        trace_id, client_span_id = ids
    attrs = _server_attrs(record, replica)
    outcome = record.get("outcome", "")
    error = bool(outcome) and outcome not in ("ok", "success", "cancelled")
    raw = list(record.get("spans", ()))
    span_ids = [derive_span_id(trace_id, replica, rec_id,
                               s.get("name", ""), str(i))
                for i, s in enumerate(raw)]
    # a span's parent is named; the first span of a name is the one meant
    by_name: Dict[str, str] = {}
    for i, s in enumerate(raw):
        by_name.setdefault(s.get("name", ""), span_ids[i])
    spans: List[Dict[str, Any]] = []
    for i, s in enumerate(raw):
        parent = s.get("parent")
        root = parent is None or parent not in by_name
        start_ns = int(s.get("start_ns", 0))
        end_ns = s.get("end_ns")
        end = int(end_ns if end_ns is not None else start_ns)
        spans.append(_span(
            trace_id, span_ids[i],
            ("server " + str(record.get("model_name", "")) if root
             else s.get("name", "")),
            SPAN_KIND_SERVER if root else SPAN_KIND_INTERNAL,
            start_ns + clock_offset_ns, end + clock_offset_ns,
            parent_span_id=client_span_id if root else by_name[parent],
            attributes=attrs if root else None,
            error=error if root else False))
    return spans


def encode_resource_spans(spans: List[Dict[str, Any]], service_name: str,
                          resource_attributes: Optional[Dict[str, Any]]
                          = None) -> Dict[str, Any]:
    """The body of one OTLP/HTTP post: one resource with every span of a
    batch."""
    attrs = [_attr("service.name", service_name)]
    attrs += [_attr(k, v)
              for k, v in sorted((resource_attributes or {}).items())]
    return {"resourceSpans": [{
        "resource": {"attributes": attrs},
        "scopeSpans": [{"scope": {"name": "triton_client_tpu_torch"},
                        "spans": spans}],
    }]}


def normalize_endpoint(endpoint: str) -> str:
    """The traces URL of an ``--otlp-endpoint``: ``host:port`` gets
    ``http://``, a URL without a path gets ``/v1/traces``."""
    url = endpoint.strip()
    if not url:
        raise ValueError("empty OTLP endpoint")
    if "://" not in url:
        url = "http://" + url
    scheme, _, rest = url.partition("://")
    if "/" not in rest:
        url = f"{scheme}://{rest}{OTLP_TRACES_PATH}"
    return url


class OtlpExporter:
    """Posts trace records to a collector, in batches, from a thread.

    ``submit(record)`` appends the record as it is (encoding waits for the
    thread: the request pays one lock and one append) or, where the queue
    holds ``queue_size`` records, counts a drop.  The thread, started by
    the first record, posts up to ``batch_max`` records at a time: when a
    batch is full, every ``flush_interval_s``, and at ``flush`` and
    ``shutdown``."""

    def __init__(self, endpoint: str, service_name: str,
                 encode: Callable[[Dict[str, Any], int],
                                  List[Dict[str, Any]]],
                 resource_attributes: Optional[Dict[str, Any]] = None,
                 queue_size: int = 4096, batch_max: int = 128,
                 flush_interval_s: float = 0.5, timeout_s: float = 5.0,
                 clock_offset_ns: Optional[int] = None) -> None:
        self.url = normalize_endpoint(endpoint)
        self.service_name = service_name
        self._encode = encode
        self._resource_attributes = dict(resource_attributes or {})
        self._queue_size = max(1, int(queue_size))
        self._batch_max = max(1, int(batch_max))
        self._flush_interval_s = flush_interval_s
        self._timeout_s = timeout_s
        self._clock_offset_ns = (
            clock_offset_ns if clock_offset_ns is not None
            else time.time_ns() - time.monotonic_ns())
        self._lock = threading.Lock()
        self._buf: List[Dict[str, Any]] = []
        self._dropped = 0
        self._exported = {"ok": 0, "error": 0}
        self._wake = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._stop = False
        self._drain = False
        self._thread: Optional[threading.Thread] = None

    # -- the request's side --------------------------------------------------
    def submit(self, record: Dict[str, Any]) -> None:
        """Queue one record; never blocks, never raises."""
        with self._lock:
            if self._stop or len(self._buf) >= self._queue_size:
                self._dropped += 1
                return
            self._buf.append(record)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="tc-torch-otlp")
                self._thread.start()
            self._idle.clear()
            # only a full batch wakes the thread: its interval takes the
            # rest, so a record costs no system call
            wake = len(self._buf) >= self._batch_max
        if wake:
            self._wake.set()

    def counters(self) -> Dict[str, int]:
        """``{"ok": posts, "error": posts, "dropped": records}``."""
        with self._lock:
            return {"ok": self._exported["ok"],
                    "error": self._exported["error"],
                    "dropped": self._dropped}

    # -- the thread's side -------------------------------------------------
    def _take(self, deadline: float) -> Tuple[List[Dict[str, Any]], bool,
                                              bool]:
        """(the batch due now, whether stopping, whether a post was due)."""
        with self._lock:
            due = (self._stop or self._drain
                   or len(self._buf) >= self._batch_max
                   or time.monotonic() >= deadline)
            batch = self._buf[:self._batch_max] if due else []
            del self._buf[:len(batch)]
            if not batch and not self._buf:
                self._drain = False
                self._idle.set()
            return batch, self._stop, due

    def _run(self) -> None:
        deadline = time.monotonic() + self._flush_interval_s
        while True:
            self._wake.wait(max(0.0, deadline - time.monotonic()))
            self._wake.clear()
            while True:
                batch, stopping, due = self._take(deadline)
                if not batch:
                    if stopping:
                        return
                    if due:
                        deadline = time.monotonic() + self._flush_interval_s
                    break
                deadline = time.monotonic() + self._flush_interval_s
                self._post(batch)

    def _post(self, batch: List[Dict[str, Any]]) -> None:
        try:
            spans: List[Dict[str, Any]] = []
            for record in batch:
                spans.extend(self._encode(record, self._clock_offset_ns))
            body = json.dumps(encode_resource_spans(
                spans, self.service_name,
                self._resource_attributes)).encode()
            req = urllib.request.Request(
                self.url, data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=self._timeout_s):
                pass
            ok = True
        except Exception:  # noqa: BLE001 - a collector's failure is a count
            ok = False
        with self._lock:
            self._exported["ok" if ok else "error"] += 1

    def flush(self, timeout_s: float = 5.0) -> bool:
        """Wait until the queue is posted; True where it was within
        ``timeout_s``."""
        with self._lock:
            self._drain = True
        self._wake.set()
        return self._idle.wait(timeout_s)

    def shutdown(self, timeout_s: float = 2.0) -> None:
        """Take no more records, post what is queued (within the time
        given) and join the thread."""
        with self._lock:
            self._stop = True
            thread = self._thread
        self._wake.set()
        if thread is not None:
            thread.join(timeout_s)
