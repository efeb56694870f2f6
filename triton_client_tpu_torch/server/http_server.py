"""HTTP/REST v2 frontend of the port, on the standard library.

Counterpart of ``triton_client_tpu/server/http_server.py`` (aiohttp there;
``http.server.ThreadingHTTPServer`` here, one thread per connection).  It
serves health and readiness, server and model metadata, model config, and
infer -- with JSON tensors and the binary-tensor-data extension: a body of
``<json header><raw buffers>`` with the JSON length in the
``Inference-Header-Content-Length`` header, in both directions.  BYTES
tensors are JSON strings, or in binary the length-prefixed serialization
with ``binary_data_size`` its length.

Shared memory (both v2 extensions, ``systemsharedmemory`` and
``cudasharedmemory``): status, register and unregister routes, and infer
inputs and outputs that name a region (``shared_memory_region``,
``shared_memory_byte_size``, ``shared_memory_offset``); an output written to
a region comes back as its name, datatype, shape and those parameters, with
no data.

Statistics: ``GET /v2/models/stats``, ``/v2/models/{m}/stats`` and
``/v2/models/{m}/versions/{v}/stats`` (``InferenceCore.statistics``, the
counters gRPC ``ModelStatistics`` reads too).

gRPC: ``POST /inference.GRPCInferenceService/<Method>`` is the v2 gRPC
service as gRPC-Web (``grpc_web.py``, ``grpc_server.py``), where the
reference mounts its bridge; the HTTP/2 listener of the gRPC port is
``grpc_h2.py``.  A request body may come with ``Content-Length`` or in
chunked transfer coding; a stream's chunks reach the bridge as they
arrive.

Observability (the reference's routes, http_server.py:135-147):
``GET``/``POST /v2/trace/setting`` and ``/v2/models/{m}/trace/setting``,
``GET``/``POST /v2/logging``, ``GET /metrics`` (Prometheus text) and the
debug snapshots ``GET /v2/debug/flight_recorder`` (``?model=``,
``?limit=``), ``/v2/debug/device_stats`` and ``/v2/debug/costs``
(``?model=``), the host profiler's ``GET /v2/debug/profile`` (collapsed
stacks, ``?role=``, ``?format=json``) and the incident bundles' ``GET``
and ``POST /v2/debug/incident`` (the reference's, http_server.py:561-600).  An infer request's trace gets its DECODE span here, and
this frontend finishes it: SERIALIZE (the response's encoding) and
NETWORK_WRITE (until the response is handed to the socket write), then the
record is emitted before the write, as the reference's (aiohttp writes
after the handler returns) and the gRPC bridge's are: a client that reads
the flight recorder after its answer finds its request there.  A
5xx is written to the server log, and each request at
``log_verbose_level`` 1.  :class:`MetricsServer` is the second listener of
``--metrics-port``: ``/metrics`` and the debug routes only.  Each
listener starts a lag probe on the core's profiler (``frontend`` for the
HTTP port, ``metrics`` for the metrics port).

Admission (the reference's, http_server.py:44-110 and :239-252): the
tenant comes from the ``triton-tenant`` header or the basic-auth username,
the priority from the v2 ``priority`` parameter, the deadline from the
``triton-timeout-us`` header over the body's ``timeout`` parameter.  A 429,
503 or 504 carries ``Retry-After`` (whole seconds) and
``triton-retry-after-ms``.  The ingress cap (``max_request_bytes``, the
``--max-request-bytes`` flag, default 64 MiB, 0 for none) answers 413 from
the declared ``Content-Length`` or ``Inference-Header-Content-Length``
before the body is read, and then reads the unread body away (or closes
the connection where it is larger than :data:`_DRAIN_LIMIT`), so that a
kept-alive connection never parses it as its next request; a chunked body
is counted as it arrives and the connection closed where it passes the
cap.  On a gRPC-Web path the same cap answers RESOURCE_EXHAUSTED.  A chaos
``abort`` closes the connection in the middle of the response's body.

Generate (the reference's ``_generate`` / ``_generate_stream``,
http_server.py:397-505): ``POST /v2/models/{m}[/versions/{v}]/generate``
answers one flat JSON object (``generate.py``), ``.../generate_stream`` a
Server-Sent Events stream in chunked transfer coding, one ``data: {json}``
frame per response; the first response is taken before the 200 is
committed, so a refused request gets its HTTP status, and a failure after
it is an in-band ``data: {"error": ...}`` frame.  A consumer that goes away
closes the core's stream (its generation is cancelled).

Request bodies in ``Content-Encoding`` gzip or deflate are inflated with
``zlib``; the ingress cap counts the inflated bytes.  An infer response
over 1,024 bytes goes back gzipped where the request's
``Accept-Encoding`` names gzip (deflate is never used for a response, as
in the reference); only that path joins the header and the segments.  HEAD is served on the
GET routes; a path that only another method's route serves gets 405 with
``Allow``; an HTTP/2 request line (the preface of a client trying h2c
first) gets an HTTP/1.1 400 and the connection closes, so such a client
falls back to gRPC-Web (HTTP/2 is served on the gRPC port).  Both
listeners serve TLS with ``tls=`` (``tls.TLSConfig``, the CLI's
``--ssl-certfile`` / ``--ssl-keyfile``): the handshake runs in the
connection's thread, and the checks above read the decrypted stream.

The repository API (the reference's, http_server.py:124-126 and
:319-345): ``POST /v2/repository/index`` (``{"ready": true}`` lists the
ready rows only), ``POST /v2/repository/models/{m}/load`` (the body's
``parameters``: ``config``, a JSON config override, and ``file:<path>``
entries, base64 files of an in-request model directory) and
``.../unload`` (``parameters.unload_dependents``).  A model's
``/versions/{v}/`` routes reach that version's instance.

OpenAI (the reference's ``openai_api.py``): ``GET /v1/models``, ``POST
/v1/completions`` and ``POST /v1/chat/completions`` (``openai_api.py``),
their errors in OpenAI's shape, ``{"error": {"message", "type"}}``; a
streamed one is SSE with the ``generate_stream`` lifecycle (the first
frame before the 200, a failure after it in band, a client that goes away
closes every choice's stream).

Responses (``wire.py``): an infer response's header is stamped from the
core's HTTP template cache (``InferenceCore.http_wire_templates``), one
compiled template per (model, output set), byte for byte the slow path's
``build_http_response_header`` dumped through ``json.dumps``; a response
with an output in JSON ``data`` takes the slow path.
"""

from __future__ import annotations

import base64
import binascii
import contextlib
import json
import math
import re
import socket
import threading
import time
import urllib.parse
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..protocol.grpc_web import CONTENT_TYPE, read_chunked, trailers
from ..protocol.service import StatusCode
from . import grpc_web, openai_api
from .chaos import ChaosAbort
from .core import InferenceCore
from .flight_recorder import parse_snapshot_limit
from .generate import build_generate_request, response_to_json, sse_frame
from .grpc_server import InferenceServicer
from .memory import DEFAULT_MAX_REQUEST_BYTES, oversize_message
from .qos import tenant_from_headers
from .tls import HANDSHAKE_TIMEOUT_S
from .trace import TRACE_DEFAULTS, validate_trace_update
from .types import (InferError, InferRequest, InputTensor, RequestedOutput,
                    ShmRef, apply_request_deadline, apply_request_priority,
                    bytes_to_array, numeric_dtype, reshape_input)
from .wire import encode_http_response

_HEADER_LEN = "Inference-Header-Content-Length"
_REQUEST_ID_HDR = "triton-request-id"
_TRACEPARENT_HDR = "traceparent"
# the client's remaining deadline in microseconds, stamped anew on each
# attempt; wins over the body's `timeout` parameter
_TIMEOUT_HDR = "triton-timeout-us"
# the QoS tenant (else the basic-auth username, else "anonymous")
_TENANT_HDR = "triton-tenant"
#: every listener's backlog of connections not yet accepted
LISTEN_BACKLOG = 128
#: an oversize body up to this many bytes is read away after the 413, so
#: the kept-alive connection stays usable; a larger one closes it
_DRAIN_LIMIT = 256 << 20


class _TooLarge(Exception):
    """A chunked request body passed the ingress cap."""


def pushback_headers(retry_after_s: Optional[float]) -> Dict[str, str]:
    """``Retry-After`` in whole seconds (RFC 7231, at least 1) and the
    precise horizon in ``triton-retry-after-ms``; none without pushback."""
    if retry_after_s is None:
        return {}
    return {"Retry-After": str(max(1, math.ceil(retry_after_s))),
            "triton-retry-after-ms": str(int(retry_after_s * 1000))}
_MODEL = r"/v2/models/(?P<model>[^/]+)(?:/versions/(?P<version>[^/]+))?"

_SHM = r"/v2/(?P<kind>systemsharedmemory|cudasharedmemory)"
_SHM_REGION = _SHM + r"/region/(?P<name>[^/]+)"

_GRPC_PREFIX = "/inference.GRPCInferenceService/"

_MODEL_TRACE = r"/v2/models/(?P<model>[^/]+)/trace/setting"

#: the observability routes, served on the HTTP port and by MetricsServer
_DEBUG_ROUTES = [
    (re.compile(r"/metrics"), "_metrics"),
    (re.compile(r"/v2/debug/flight_recorder"), "_flight_recorder"),
    (re.compile(r"/v2/debug/device_stats"), "_device_stats"),
    (re.compile(r"/v2/debug/costs"), "_costs"),
    (re.compile(r"/v2/debug/profile"), "_profile"),
    (re.compile(r"/v2/debug/incident"), "_incident_status"),
]
_DEBUG_POST_ROUTES = [
    (re.compile(r"/v2/debug/incident"), "_incident_trigger"),
]

_GET_ROUTES = [
    (re.compile(r"/v2/health/live"), "_health_live"),
    (re.compile(r"/v2/health/ready"), "_health_ready"),
    (re.compile(_MODEL + r"/ready"), "_model_ready"),
    (re.compile(r"/v2"), "_server_metadata"),
    # before the metadata route, which would take "stats" for a model name
    (re.compile(r"/v2/models/stats"), "_model_stats"),
    (re.compile(_MODEL + r"/stats"), "_model_stats"),
    (re.compile(_MODEL + r"/config"), "_model_config"),
    (re.compile(_MODEL), "_model_metadata"),
    (re.compile(_SHM + r"/status"), "_shm_status"),
    (re.compile(_SHM_REGION + r"/status"), "_shm_status"),
    (re.compile(r"/v2/trace/setting"), "_get_trace"),
    (re.compile(_MODEL_TRACE), "_get_trace"),
    (re.compile(r"/v2/logging"), "_get_logging"),
    (re.compile(r"/v1/models"), "_oai_models"),
    *_DEBUG_ROUTES,
]
_POST_ROUTES = [
    (re.compile(_MODEL + r"/infer"), "_infer"),
    (re.compile(_MODEL + r"/generate"), "_generate"),
    (re.compile(_MODEL + r"/generate_stream"), "_generate_stream"),
    (re.compile(r"/v2/trace/setting"), "_set_trace"),
    (re.compile(_MODEL_TRACE), "_set_trace"),
    (re.compile(r"/v2/logging"), "_set_logging"),
    (re.compile(_SHM_REGION + r"/register"), "_shm_register"),
    (re.compile(_SHM + r"/unregister"), "_shm_unregister"),
    (re.compile(_SHM_REGION + r"/unregister"), "_shm_unregister"),
    (re.compile(r"/v2/repository/index"), "_repo_index"),
    (re.compile(r"/v2/repository/models/(?P<model>[^/]+)/load"),
     "_repo_load"),
    (re.compile(r"/v2/repository/models/(?P<model>[^/]+)/unload"),
     "_repo_unload"),
    (re.compile(r"/v1/completions"), "_oai_completions"),
    (re.compile(r"/v1/chat/completions"), "_oai_chat_completions"),
    *_DEBUG_POST_ROUTES,
]


def _json_body(obj) -> bytes:
    return json.dumps(obj).encode("utf-8")


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # TCP_NODELAY on each accepted socket: a response goes out in more than
    # one write (headers and JSON, then each binary segment), and with
    # Nagle's algorithm the second write of a kept-alive connection would
    # wait for the client's delayed ACK (~40 ms)
    disable_nagle_algorithm = True
    server: "HttpServer"

    def log_message(self, format, *args):  # noqa: A002 - stdlib signature
        pass  # no per-request stderr lines

    #: the routes of each method; HEAD serves GET's
    ROUTES = {"GET": _GET_ROUTES, "POST": _POST_ROUTES}

    # -- dispatch ----------------------------------------------------------
    def parse_request(self) -> bool:
        """An HTTP/2 request line (h2c's ``PRI * HTTP/2.0`` preface) gets
        an HTTP/1.1 status line and headers, then the connection closes:
        the stdlib would answer it without a status line."""
        words = self.raw_requestline.split()
        if len(words) == 3 and words[2].upper().startswith(
                (b"HTTP/2", b"HTTP/3")):
            self.command = words[0].decode("latin-1")
            self.requestline = self.raw_requestline.decode(
                "latin-1").rstrip("\r\n")
            self.request_version = "HTTP/1.1"
            self.close_connection = True
            self.send_error(400, None, "this port speaks HTTP/1.1 only; "
                            "gRPC is served as gRPC-Web here and over "
                            "HTTP/2 on the gRPC port")
            return False
        return super().parse_request()

    def do_GET(self):
        self._dispatch(self.ROUTES["GET"])

    def do_HEAD(self):
        self._dispatch(self.ROUTES["GET"])

    def do_POST(self):
        self._dispatch(self.ROUTES["POST"])

    def do_PUT(self):
        self._dispatch([])

    do_DELETE = do_PATCH = do_OPTIONS = do_PUT

    def _dispatch(self, routes) -> None:
        with self.server.exchange():
            self._dispatch_one(routes)

    def _allowed(self, path: str) -> List[str]:
        """The methods whose routes serve ``path``."""
        out = []
        for method, routes in self.ROUTES.items():
            if any(p.fullmatch(path) for p, _ in routes):
                out += [method, "HEAD"] if method == "GET" else [method]
        return out

    def _dispatch_one(self, routes) -> None:
        path = urllib.parse.unquote(self.path.split("?", 1)[0])
        self._query = urllib.parse.parse_qs(
            urllib.parse.urlsplit(self.path).query)
        grpc = (self.command == "POST" and path.startswith(_GRPC_PREFIX)
                and path[len(_GRPC_PREFIX):] in self.server.grpc_methods)
        if self._refuse_oversize(grpc):
            return
        if grpc:
            self._grpc(path[len(_GRPC_PREFIX):])
            return
        try:
            body = self._read_body()
        except _TooLarge as e:
            self.close_connection = True
            self._send_oversize(int(str(e)), False)
            return
        except (ConnectionError, ValueError):
            self.close_connection = True
            self._send(400, _json_body({"error": "malformed request body"}))
            return
        for pattern, handler in routes:
            match = pattern.fullmatch(path)
            if match is None:
                continue
            rid = self.headers.get(_REQUEST_ID_HDR, "")
            log = self.core.log
            try:
                getattr(self, handler)(match.groupdict(), body)
                log.verbose(1, f"{self.command} {path} -> 200", rid)
            except ChaosAbort:
                self._abort_mid_response()
            except InferError as e:
                if e.http_status >= 500:
                    log.error(f"{self.command} {path} failed: {e}", rid)
                else:
                    log.verbose(1, f"{self.command} {path} -> "
                                   f"{e.http_status}: {e}", rid)
                self._send(e.http_status, _json_body({"error": str(e)}),
                           pushback_headers(e.retry_after_s))
            except Exception as e:  # noqa: BLE001 - a handler bug is a 500
                log.error(f"{self.command} {path} crashed: {e}", rid)
                self._send(500, _json_body({"error": str(e)}))
            return
        allowed = self._allowed(path)
        if allowed:
            self._send(405, _json_body(
                {"error": f"method {self.command} is not allowed for "
                          f"{path}"}), {"Allow": ", ".join(allowed)})
            return
        self._send(404, _json_body({"error": f"no route for {path}"}))

    def _read_body(self) -> bytes:
        """The request body, inflated where its ``Content-Encoding`` is
        gzip or deflate.  The ingress cap counts the bytes as they arrive
        (a chunked body) and then the inflated bytes: a compressed body
        that inflates past the cap is refused as one sent that large."""
        cap = self.server.max_request_bytes
        if not cap or "chunked" not in self.headers.get(
                "Transfer-Encoding", "").lower():
            return self._inflate(b"".join(self._body_chunks()))
        parts, total = [], 0
        for chunk in self._body_chunks():
            total += len(chunk)
            if total > cap:
                raise _TooLarge(total)
            parts.append(chunk)
        return self._inflate(b"".join(parts))

    def _inflate(self, body: bytes) -> bytes:
        enc = self.headers.get("Content-Encoding", "").strip().lower()
        if enc in ("", "identity") or not body:
            return body
        if enc in ("gzip", "x-gzip"):
            wbits = 16 + zlib.MAX_WBITS
        elif enc == "deflate":
            # zlib-wrapped (RFC 1950, what clients send), else raw deflate
            zlib_header = (len(body) > 1 and body[0] & 0x0F == 8
                           and (body[0] << 8 | body[1]) % 31 == 0)
            wbits = zlib.MAX_WBITS if zlib_header else -zlib.MAX_WBITS
        else:
            raise ValueError(f"unsupported Content-Encoding {enc!r}")
        cap = self.server.max_request_bytes
        d = zlib.decompressobj(wbits)
        try:
            out = d.decompress(body, cap + 1) if cap else d.decompress(body)
        except zlib.error as e:
            raise ValueError(f"corrupt {enc} body: {e}")
        if cap and len(out) > cap:
            raise _TooLarge(len(out))
        if not d.eof:
            raise ValueError(f"truncated {enc} body")
        return out

    def _body_chunks(self) -> Iterator[bytes]:
        """The request body as it arrives: one piece for a
        ``Content-Length`` body, each chunk of a chunked one."""
        if "chunked" in self.headers.get("Transfer-Encoding", "").lower():
            yield from read_chunked(self.rfile)
            return
        n = int(self.headers.get("Content-Length") or 0)
        if n:
            yield self.rfile.read(n)

    # -- ingress cap and chaos abort -----------------------------------------
    def _refuse_oversize(self, grpc: bool) -> bool:
        """Answer a request whose declared size passes the ingress cap,
        before reading its body; then read the body away, or close the
        connection where it is too large to read."""
        cap = self.server.max_request_bytes
        if not cap or self.command != "POST":
            return False
        try:
            declared = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            declared = 0
        size = declared
        if size <= cap:
            try:
                size = int(self.headers.get(_HEADER_LEN) or 0)
            except ValueError:
                return False  # the handler reports the junk header
            if size <= cap:
                return False
        if declared and declared <= _DRAIN_LIMIT and "chunked" not in \
                self.headers.get("Transfer-Encoding", "").lower():
            self._send_oversize(size, grpc)
            self._discard(declared)
        else:
            self.close_connection = True
            self._send_oversize(size, grpc)
        return True

    def _send_oversize(self, size: int, grpc: bool) -> None:
        cap = self.server.max_request_bytes
        msg = oversize_message(size, cap)
        if grpc:
            self._send(200, trailers(StatusCode.RESOURCE_EXHAUSTED, msg),
                       {"grpc-status": str(int(
                           StatusCode.RESOURCE_EXHAUSTED))},
                       content_type=CONTENT_TYPE)
            return
        self._send(413, _json_body({"error": msg}),
                   {"Retry-After": "1", "triton-retry-after-ms": "1000",
                    "triton-max-request-bytes": str(cap)})

    def _discard(self, n: int) -> None:
        """Read ``n`` body bytes away, a MiB at a time."""
        while n > 0:
            got = self.rfile.read(min(n, 1 << 20))
            if not got:
                self.close_connection = True
                return
            n -= len(got)

    def _abort_mid_response(self) -> None:
        """A chaos ``abort``: the head of a response and part of its body,
        then the connection closed, so the client reads a connection that
        broke in the middle of a response (not a stale kept-alive one)."""
        self.close_connection = True
        try:
            self.wfile.write(b"HTTP/1.1 503 Service Unavailable\r\n"
                             b"Content-Type: application/json\r\n"
                             b"Content-Length: 64\r\n\r\n{\"error\": ")
            self.wfile.flush()
        except OSError:
            pass

    def _grpc(self, method: str) -> None:
        """One gRPC-Web call (``grpc_web.serve``)."""
        def start_stream():
            self.send_response(200)
            self.send_header("Content-Type", CONTENT_TYPE)
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def write(data: bytes) -> None:
                # tpu-lint: disable=WIRE-COPY a chunk's size line and its frame in one write
                self.wfile.write(b"%X\r\n%s\r\n" % (len(data), data)
                                 if data else b"0\r\n\r\n")
            return write

        def send(status, payload, headers, content_type):
            self._send(status, payload, headers, content_type=content_type)

        metadata = {k.lower(): v for k, v in self.headers.items()}
        try:
            grpc_web.serve(self.server.servicer, method,
                           self.headers.get("Content-Type", ""),
                           self._body_chunks(), send, start_stream,
                           metadata)
        except (ConnectionError, ValueError):
            # the client went away, or its chunked body was malformed: the
            # exchange cannot go on on this connection
            self.close_connection = True
        if grpc_web.METHODS.get(method, ("uu",))[0] != "uu":
            # a stream that ended early leaves its body unread
            self.close_connection = True

    def _send(self, status: int, payload: bytes = b"",
              headers: Optional[Dict[str, str]] = None,
              content_type: str = "application/json",
              segments: Sequence[memoryview] = ()) -> None:
        """One response: the status line, headers and ``payload`` in one
        write, then each raw ``segment`` in turn (binary tensors are never
        joined into one buffer)."""
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length",
                         str(len(payload) + sum(s.nbytes for s in segments)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        if self.close_connection:
            self.send_header("Connection", "close")
        if self.command == "HEAD":
            # the GET response's headers, no body
            self._headers_buffer.append(b"\r\n")
            self.flush_headers()
            return
        # end_headers() without its own write: the blank line and the
        # payload join the buffered status line and headers, which
        # flush_headers() sends as one write
        self._headers_buffer.append(b"\r\n" + payload)
        self.flush_headers()
        for seg in segments:
            self.wfile.write(seg)

    @property
    def core(self) -> InferenceCore:
        return self.server.core

    # -- health / metadata -------------------------------------------------
    def _health_live(self, groups, body):
        self._send(200 if self.core.live else 400)

    def _health_ready(self, groups, body):
        self._send(200 if self.core.ready() else 400)

    def _model_ready(self, groups, body):
        ok = self.core.model_ready(groups["model"], groups["version"] or "")
        self._send(200 if ok else 400)

    def _server_metadata(self, groups, body):
        self._send(200, _json_body(self.core.server_metadata()))

    def _model_metadata(self, groups, body):
        model = self.core.registry.get(groups["model"],
                                       groups["version"] or "")
        self._send(200, _json_body(model.metadata()))

    def _model_config(self, groups, body):
        model = self.core.registry.get(groups["model"],
                                       groups["version"] or "")
        self._send(200, _json_body(model.config.to_json()))

    def _model_stats(self, groups, body):
        stats = self.core.statistics(groups.get("model"),
                                     groups.get("version") or "")
        self._send(200, _json_body({"model_stats": stats}))

    # -- shared memory -----------------------------------------------------
    def _shm_registry(self, groups):
        return (self.core.system_shm if groups["kind"] == "systemsharedmemory"
                else self.core.cuda_shm)

    def _shm_status(self, groups, body):
        status = self._shm_registry(groups).status(groups.get("name"))
        self._send(200, _json_body(list(status.values())))

    def _shm_register(self, groups, body):
        reg = self._shm_registry(groups)
        name = groups["name"]
        try:
            req = json.loads(body)
        except ValueError:
            raise InferError("failed to parse request JSON")
        if not isinstance(req, dict):
            raise InferError("request body must be a JSON object")
        system = reg is self.core.system_shm
        needed = ("key", "byte_size") if system else ("raw_handle",
                                                      "byte_size")
        missing = [k for k in needed if k not in req]
        if missing:
            raise InferError(
                f"shared memory registration missing field(s): {missing}")
        try:
            if system:
                reg.register(name, req["key"], int(req.get("offset", 0)),
                             int(req["byte_size"]))
            else:
                handle = req["raw_handle"]
                if not isinstance(handle, dict) or "b64" not in handle:
                    raise InferError(
                        "raw_handle must be an object with a 'b64' field")
                raw = base64.b64decode(handle["b64"], validate=True)
                reg.register(name, raw, int(req.get("device_id", 0)),
                             int(req["byte_size"]))
        except (TypeError, ValueError, binascii.Error) as e:
            raise InferError(f"invalid shared memory registration: {e}")
        self._send(200)

    def _shm_unregister(self, groups, body):
        self._shm_registry(groups).unregister(groups.get("name"))
        self._send(200)

    # -- the repository ------------------------------------------------------
    def _repo_index(self, groups, body):
        ready = bool(_json_object(body).get("ready", False))
        self._send(200, _json_body(self.core.registry.index(
            ready_only=ready)))

    def _repo_load(self, groups, body):
        params = _json_object(body).get("parameters", {}) or {}
        files = {k: v for k, v in params.items() if k.startswith("file:")}
        self.core.load_model(groups["model"],
                             config_override=params.get("config"),
                             files=files or None)
        self._send(200)

    def _repo_unload(self, groups, body):
        params = _json_object(body).get("parameters", {}) or {}
        self.core.unload_model(
            groups["model"],
            unload_dependents=bool(params.get("unload_dependents")))
        self._send(200)

    # -- OpenAI ----------------------------------------------------------------
    def _oai_models(self, groups, body):
        self._send(200, _json_body(openai_api.models_body(self.core)))

    def _oai_completions(self, groups, body):
        self._oai(body, chat=False)

    def _oai_chat_completions(self, groups, body):
        self._oai(body, chat=True)

    def _oai(self, raw: bytes, chat: bool) -> None:
        """One OpenAI request; its errors in OpenAI's shape."""
        frames = None
        try:
            out, frames = openai_api.completion(self.core, raw, self.headers,
                                                chat)
            if frames is None:
                self._send(200, _json_body(out))
                return
            # the first frame before the 200: a refusal (429, no free
            # slot) gets its own status
            first = next(frames, None)
        except Exception as e:  # noqa: BLE001 - OpenAI's error shape
            if frames is not None:
                frames.close()
            status, payload = openai_api.error_body(e)
            if status >= 500:
                self.core.log.error(f"POST {self.path} failed: {e}")
            self._send(status, _json_body(payload))
            return
        try:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            try:
                if first is not None:
                    self._write_chunk(first)
                for frame in frames:
                    self._write_chunk(frame)
            except InferError as e:
                # the headers are out: the failure goes in band
                self._write_chunk(openai_api.error_frame(e))
            except OSError:
                # the client went away: every choice's stream closes below
                self.close_connection = True
                return
            self._write_chunk(b"")
        finally:
            frames.close()

    # -- trace and log settings ----------------------------------------------
    def _get_trace(self, groups, body):
        model = groups.get("model")
        if model:
            self.core.registry.get(model)  # an unknown model is a 400
            self._send(200, _json_body(
                self.core.tracer.effective_settings(model)))
            return
        self._send(200, _json_body(self.core.trace_settings))

    def _set_trace(self, groups, body):
        core = self.core
        model = groups.get("model")
        req = _json_object(body)
        if model:
            core.registry.get(model)
            update, cleared = {}, []
            for k, v in req.items():
                if v is None:
                    # null in a model's scope: inherit the global value
                    if k not in TRACE_DEFAULTS:
                        raise InferError(f"unknown trace setting '{k}'", 400)
                    cleared.append(k)
                else:
                    update[k] = v if isinstance(v, list) else [str(v)]
            validate_trace_update(update, model_scope=True)
            if update or cleared:
                core.tracer.update_model(model, update, cleared)
            self._send(200, _json_body(core.tracer.effective_settings(model)))
            return
        update = {}
        for k, v in req.items():
            # null clears to the default
            update[k] = (list(TRACE_DEFAULTS.get(k, [])) if v is None
                         else v if isinstance(v, list) else [str(v)])
        validate_trace_update(update)
        if update:  # an empty body is a read
            core.trace_settings.update(update)
            core.tracer.settings_updated()
        self._send(200, _json_body(core.trace_settings))

    def _get_logging(self, groups, body):
        self._send(200, _json_body(self.core.log_settings))

    def _set_logging(self, groups, body):
        self.core.log_settings.update(_json_object(body))
        self._send(200, _json_body(self.core.log_settings))

    # -- /metrics and the debug snapshots --------------------------------------
    def _query_one(self, key: str, default: str = "") -> str:
        vals = self._query.get(key)
        return vals[0] if vals else default

    def _metrics(self, groups, body):
        from .metrics import render_prometheus

        self._send(200, render_prometheus(self.core).encode("utf-8"),
                   content_type="text/plain; charset=utf-8")

    def _flight_recorder(self, groups, body):
        limit = parse_snapshot_limit(self._query_one("limit", "0"))
        self._send(200, _json_body(self.core.flight_recorder.snapshot(
            model=self._query_one("model") or None, limit=limit)))

    def _device_stats(self, groups, body):
        self._send(200, _json_body(self.core.device_stats_snapshot(
            self._query_one("model") or None)))

    def _costs(self, groups, body):
        self._send(200, _json_body(self.core.cost_ledger.snapshot(
            model=self._query_one("model") or None)))

    def _profile(self, groups, body):
        """The host profiler's window as collapsed-stack text (``?role=``
        one role's), or its snapshot with ``?format=json``."""
        profiler = self.core.profiler
        if self._query_one("format") == "json":
            self._send(200, _json_body(profiler.snapshot()))
            return
        text = profiler.collapsed(self._query_one("role") or None)
        self._send(200, text.encode("utf-8"),
                   content_type="text/plain; charset=utf-8")

    def _incident_status(self, groups, body):
        self._send(200, _json_body(self.core.incidents.snapshot()))

    def _incident_trigger(self, groups, body):
        """A manual bundle (``{"reason": ...}``, optional), written before
        the answer, which names it; 202 ``rate_limited`` inside the manual
        class's interval."""
        reason = str(_json_object(body).get("reason", "manual trigger"))
        path = self.core.incidents.trigger("manual", reason=reason,
                                           sync=True)
        if path is None:
            self._send(202, _json_body({"status": "rate_limited",
                                        "bundle": None}))
            return
        self._send(200, _json_body({"status": "written", "bundle": path}))

    # -- infer -------------------------------------------------------------
    def _infer(self, groups, raw: bytes):
        decode_start = time.monotonic_ns()
        header_len = self.headers.get(_HEADER_LEN)
        if header_len is not None:
            try:
                hlen = int(header_len)
            except ValueError:
                raise InferError(
                    f"invalid {_HEADER_LEN} header: {header_len!r}")
            json_bytes, binary = raw[:hlen], raw[hlen:]
        else:
            json_bytes, binary = raw, b""
        try:
            body = json.loads(json_bytes)
        except ValueError:
            raise InferError("failed to parse inference request JSON")
        req = decode_request(groups["model"], groups["version"] or "",
                             body, binary)
        req.decode_start_ns, req.decode_end_ns = (decode_start,
                                                  time.monotonic_ns())
        self._stamp(req, raw)
        # this frontend finishes the trace: SERIALIZE and NETWORK_WRITE
        req.trace_handoff = True
        resp = self.core.infer(req)
        trace = resp.trace
        try:
            t_ser0 = time.monotonic_ns()
            default_binary = bool(req.parameters.get(
                "binary_data_output", header_len is not None))
            header, segments = encode_http_response(
                resp, {o.name: o for o in req.outputs}, default_binary,
                self.core.http_wire_templates,
                self.core.registry.generation(resp.model_name))
            headers = {_HEADER_LEN: str(len(header))}
            if req.client_request_id:
                headers[_REQUEST_ID_HDR] = req.client_request_id
            t_ser1 = time.monotonic_ns()
            # the reference's rule: gzip where the client accepts it and
            # the body is over 1 KiB (deflate is never used); counted in
            # NETWORK_WRITE, as the reference counts it
            if "gzip" in self.headers.get("Accept-Encoding", "") and \
                    len(header) + sum(s.nbytes for s in segments) > 1024:
                header = _gzip_response(header, segments)
                segments = ()
                headers["Content-Encoding"] = "gzip"
            if trace is not None:
                trace.add_span("SERIALIZE", t_ser0, t_ser1)
                trace.add_span("NETWORK_WRITE", t_ser1, time.monotonic_ns())
        except BaseException as e:
            # a failure after the core's success is still a failure
            if trace is not None:
                trace.mark_failed(e)
            raise
        finally:
            if trace is not None:
                trace.emit()
        self._send(200, header, headers,
                   content_type="application/octet-stream",
                   segments=segments)


    def _stamp(self, req: InferRequest, raw: bytes) -> None:
        """The request's trace ids, wire size and admission fields
        (deadline, tenant, priority) from this exchange."""
        req.client_request_id = self.headers.get(_REQUEST_ID_HDR, "")
        req.traceparent = self.headers.get(_TRACEPARENT_HDR, "")
        req.protocol = "http"
        req.wire_bytes = len(raw)
        apply_request_deadline(req, header_us=self.headers.get(_TIMEOUT_HDR))
        req.tenant = tenant_from_headers(self.headers.get(_TENANT_HDR),
                                         self.headers.get("Authorization"))
        apply_request_priority(req)

    # -- generate ------------------------------------------------------------
    def _build_generate(self, groups, raw: bytes):
        name, version = groups["model"], groups["version"] or ""
        model = self.core.registry.get(name, version)
        try:
            body = json.loads(raw)
        except ValueError:
            raise InferError("failed to parse generate request JSON", 400)
        req = build_generate_request(model, name, version, body)
        self._stamp(req, raw)
        return name, version, model, req

    def _generate(self, groups, raw: bytes):
        name, version, model, req = self._build_generate(groups, raw)
        if model.decoupled:
            raise InferError(
                f"model '{name}' is decoupled: use generate_stream", 400)
        resp = self.core.infer(req)
        self._send(200, response_to_json(name, version, resp).encode())

    def _write_chunk(self, data: bytes) -> None:
        """One chunk of a chunked body in one write (empty: the end)."""
        # tpu-lint: disable=WIRE-COPY a chunk's size line and its frame in one write
        self.wfile.write(b"%X\r\n%s\r\n" % (len(data), data)
                         if data else b"0\r\n\r\n")

    def _generate_stream(self, groups, raw: bytes):
        name, version, _model, req = self._build_generate(groups, raw)
        stream = self.core.infer_stream(req)
        try:
            # the first response before the 200: a refused request gets
            # its own status
            first = next(stream, None)
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            try:
                for resp in ([first] if first is not None else []):
                    self._write_event(name, version, resp)
                for resp in stream:
                    self._write_event(name, version, resp)
            except InferError as e:
                # the headers are out: the failure goes in band
                self._write_chunk(sse_frame(json.dumps({"error": str(e)})))
            except OSError:
                # the client went away: the stream closes below
                self.close_connection = True
                return
            self._write_chunk(b"")
        finally:
            stream.close()

    def _write_event(self, name: str, version: str, resp) -> None:
        if not resp.outputs:
            return  # a decoupled stream's final empty response
        t0 = time.monotonic_ns()
        self._write_chunk(sse_frame(response_to_json(name, version, resp)))
        if resp.trace is not None:
            resp.trace.record_write(t0, time.monotonic_ns())


def _gzip_response(header: bytes, segments: Sequence[memoryview]) -> bytes:
    """A binary infer response's header and segments, gzipped as one body
    (the one path that joins them)."""
    z = zlib.compressobj(6, zlib.DEFLATED, 16 + zlib.MAX_WBITS)
    out = [z.compress(header), *(z.compress(seg) for seg in segments),
           z.flush()]
    return b"".join(out)


def _json_object(body: bytes) -> dict:
    """A settings body as a JSON object ({} when empty); anything else is
    a 400."""
    if not body:
        return {}
    try:
        obj = json.loads(body)
    except ValueError:
        raise InferError("failed to parse request JSON")
    if not isinstance(obj, dict):
        raise InferError("request body must be a JSON object")
    return obj


def decode_request(model_name: str, version: str, body: dict,
                   binary: bytes) -> InferRequest:
    """A v2 infer request body (plus its binary section) as an
    :class:`InferRequest`; malformed input is a 400."""
    if not isinstance(body, dict):
        raise InferError("inference request body must be a JSON object")
    if not isinstance(body.get("inputs", []), list) \
            or not isinstance(body.get("outputs", []), list):
        raise InferError("'inputs'/'outputs' must be arrays")
    if not isinstance(body.get("parameters", {}) or {}, dict):
        raise InferError("'parameters' must be an object")
    req = InferRequest(model_name=model_name, model_version=version,
                       id=body.get("id", ""),
                       parameters=body.get("parameters", {}) or {})
    offset = 0
    for t in body.get("inputs", []):
        try:
            name, datatype = t["name"], t["datatype"]
            shape = tuple(int(s) for s in t["shape"])
        except (TypeError, KeyError, ValueError, AttributeError) as e:
            raise InferError(f"malformed input specification: {e}")
        params = t.get("parameters", {}) or {}
        if not isinstance(params, dict):
            raise InferError(f"input '{name}' parameters must be an object")
        tensor = InputTensor(name=name, datatype=datatype, shape=shape,
                             parameters=params)
        bin_size = params.get("binary_data_size")
        try:
            if params.get("shared_memory_region"):
                tensor.shm = _shm_ref(params)
            elif bin_size is not None:
                chunk = binary[offset:offset + int(bin_size)]
                if len(chunk) != int(bin_size):
                    raise InferError(
                        f"unexpected end of binary data for input '{name}'")
                offset += int(bin_size)
                tensor.data = bytes_to_array(chunk, datatype, shape, name)
            elif "data" in t:
                tensor.data = _json_to_array(t["data"], datatype, shape, name)
            else:
                raise InferError(f"input '{name}' has no data")
        except (TypeError, KeyError, ValueError, AttributeError) as e:
            raise InferError(f"malformed input '{name}': {e}")
        req.inputs.append(tensor)
    for o in body.get("outputs", []) or []:
        try:
            params = o.get("parameters", {}) or {}
            if not isinstance(params, dict):
                raise InferError("output parameters must be an object")
            out = RequestedOutput(
                name=o["name"],
                binary_data=bool(params.get("binary_data", False)),
                class_count=int(params.get("classification", 0)),
                parameters=params)
            if params.get("shared_memory_region"):
                out.shm = _shm_ref(params)
            req.outputs.append(out)
        except (TypeError, KeyError, ValueError, AttributeError) as e:
            raise InferError(f"malformed output specification: {e}")
    return req


def _shm_ref(params: dict) -> ShmRef:
    """The region a tensor's parameters name (KeyError / ValueError on a
    malformed one, which the caller reports)."""
    return ShmRef(region_name=params["shared_memory_region"],
                  byte_size=int(params["shared_memory_byte_size"]),
                  offset=int(params.get("shared_memory_offset", 0)))


def _flatten(x):
    if isinstance(x, list):
        for item in x:
            yield from _flatten(item)
    else:
        yield x


def _json_to_array(data, datatype: str, shape, name: str):
    if datatype == "BYTES":
        def coerce(x):
            if isinstance(x, str):
                return x.encode("utf-8")
            if isinstance(x, (bytes, bytearray, list)):
                return bytes(x)
            # bytes(int) would allocate that many zero bytes
            raise InferError(
                f"BYTES input '{name}' elements must be strings or byte "
                f"arrays, got {type(x).__name__}")
        flat = np.array([coerce(x) for x in _flatten(data)], dtype=np.object_)
        return reshape_input(flat, shape, name)
    if datatype == "BF16":
        try:
            flat = torch.tensor(list(_flatten(data)), dtype=torch.float32)
            return flat.to(torch.bfloat16).reshape(tuple(shape))
        except (ValueError, TypeError, RuntimeError) as e:
            raise InferError(f"invalid data for input '{name}': {e}")
    dt = numeric_dtype(datatype, name)
    try:
        arr = np.array(data, dtype=dt)
    except (ValueError, TypeError) as e:
        raise InferError(f"invalid data for input '{name}': {e}")
    return reshape_input(arr, shape, name)


class _CountingServer(ThreadingHTTPServer):
    """A threading HTTP server that counts the exchanges in progress (a
    request read until its response is written), so that a drain can wait
    for the answers, not only for the core's requests.

    With ``tls`` (a ``tls.TLSConfig``) every accepted socket is wrapped
    without its handshake, which then runs in the connection's own thread
    under ``HANDSHAKE_TIMEOUT_S``: a slow or silent client holds only its
    own thread, never the accept loop.  A connection whose handshake
    fails (a plain-HTTP client, an untrusted certificate) is closed.
    ``grpc`` takes the gRPC port's context (ALPN ``h2``).  Every listener
    keeps a backlog of :data:`LISTEN_BACKLOG` connections."""

    daemon_threads = True
    active = 0
    #: the listen backlog, as the reference's listeners have it (aiohttp's
    #: ``TCPSite``): the stdlib's 5 overflows under a burst of connects
    request_queue_size = LISTEN_BACKLOG

    def __init__(self, *args, tls=None, grpc=False, **kwargs):
        self._active_lock = threading.Lock()
        # the accepted connections still open
        self._conns: set = set()
        # built before the bind: a pair that does not load fails at start
        self.ssl_context = None if tls is None else (
            tls.grpc_ssl_context() if grpc else tls.ssl_context())
        super().__init__(*args, **kwargs)

    def get_request(self):
        sock, addr = super().get_request()
        if self.ssl_context is not None:
            sock = self.ssl_context.wrap_socket(
                sock, server_side=True, do_handshake_on_connect=False)
        return sock, addr

    def process_request_thread(self, request, client_address):
        if self.ssl_context is not None:
            try:
                request.settimeout(HANDSHAKE_TIMEOUT_S)
                request.do_handshake()
                request.settimeout(None)
            except OSError:  # ssl.SSLError and timeouts included
                self.shutdown_request(request)
                return
        super().process_request_thread(request, client_address)

    def process_request(self, request, client_address):
        with self._active_lock:
            self._conns.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._active_lock:
            self._conns.discard(request)
        super().shutdown_request(request)

    def close_connections(self) -> None:
        """Cut every open connection, as the process's end would: a
        kept-alive client must not go on reaching a stopped server's
        handler threads."""
        with self._active_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # closed meanwhile

    @contextlib.contextmanager
    def exchange(self):
        with self._active_lock:
            self.active += 1
        try:
            yield
        finally:
            with self._active_lock:
                self.active -= 1


class HttpServer(_CountingServer):
    """The v2 HTTP frontend bound to one :class:`InferenceCore`.  With
    ``reuse_port`` the port is bound with ``SO_REUSEPORT``: the
    ``--frontends`` workers share it and the kernel spreads the accepted
    connections (the reference's ``start_frontends(reuse_port=...)``)."""

    def __init__(self, core: InferenceCore, host: str = "127.0.0.1",
                 port: int = 8000,
                 max_request_bytes: int = DEFAULT_MAX_REQUEST_BYTES,
                 reuse_port: bool = False, tls=None):
        self.core = core
        self.allow_reuse_port = reuse_port
        #: the ingress cap in bytes (0: none)
        self.max_request_bytes = max(0, int(max_request_bytes or 0))
        self.servicer = InferenceServicer(core, self.max_request_bytes)
        self.grpc_methods = set(grpc_web.METHODS)
        super().__init__((host, port), _Handler, tls=tls)
        core.profiler.install_loop_probe("frontend")


class _MetricsHandler(_Handler):
    """``/metrics`` and the debug snapshots, nothing else."""

    ROUTES = {"GET": _DEBUG_ROUTES, "POST": _DEBUG_POST_ROUTES}


class MetricsServer(_CountingServer):
    """The ``--metrics-port`` listener (the reference's
    ``build_metrics_app``): ``/metrics`` and the debug snapshots of one
    :class:`InferenceCore`."""

    def __init__(self, core: InferenceCore, host: str = "127.0.0.1",
                 port: int = 8002, tls=None):
        self.core = core
        self.max_request_bytes = 0
        self.grpc_methods = set()
        super().__init__((host, port), _MetricsHandler, tls=tls)
        core.profiler.install_loop_probe("metrics")
