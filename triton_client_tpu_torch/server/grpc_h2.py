"""The v2 gRPC service over HTTP/2 on the port's gRPC port.

Counterpart of ``build_grpc_server`` (``triton_client_tpu/server/
grpc_server.py:646-675``) and of the gRPC half of ``frontends.py``: the
reference serves gRPC with ``grpc.aio``; the machine the port serves on
has no ``grpcio``, so this listener speaks HTTP/2 itself, on the port's
sans-IO connection (``protocol/h2.py``, ``protocol/hpack.py``).  Prior
knowledge over TCP (h2c), or ALPN ``h2`` under TLS (``tls.py``'s
``grpc_ssl_context``: a stock gRPC client refuses a TLS peer that does
not negotiate it).  The call itself (the cap, the encodings, unary
against stream, the status) is ``grpc_server.py``'s, which the gRPC-Web
bridge of the HTTP port shares; the same :class:`InferenceServicer`
answers both.

Threads: a connection's own thread reads its frames (and runs its TLS
handshake, as the HTTP port's do); each stream's call runs on a thread of
its own (``tc-torch-h2-call``), so the streams of one connection -- a
channel's ``async_infer`` calls, say -- are served at once.  The
connection's state is driven under one condition; a writer lock orders
the writes, and the reader never waits for it (a writer flushes what the
reader queued).  A call that has more to send than the peer's window
waits on the condition for WINDOW_UPDATE: a slow stream never blocks the
connection.  A DATA payload is copied once, into its stream's queue, and
acknowledged (WINDOW_UPDATE) as the call's thread consumes it.

A request: ``:method POST`` (else HTTP 405), ``content-type
application/grpc[+proto]`` (else 415), ``te: trailers`` (else 400), a path
``/inference.GRPCInferenceService/<Method>`` (one that names no method
answers UNIMPLEMENTED ``Method not found!``, as grpcio does).  The other
headers are the call's metadata (``triton-tenant``, ``authorization``,
``traceparent``, ``triton-request-id``, ``grpc-encoding``).
``grpc-timeout`` sets the call's deadline, at whose end the call is
answered DEADLINE_EXCEEDED (``Deadline Exceeded``) as grpcio's server
answers it; the work goes on and its answer is dropped.  RST_STREAM from
the client cancels the call: its reads and writes raise, so a stream's
servicer is closed as when a gRPC-Web client's connection goes
(``cancel_requests``).

An answer is HEADERS (``:status 200``, ``content-type
application/grpc``), DATA frames (one message each, split to the peer's
frame size and window), then trailers: ``grpc-status``, a
percent-encoded ``grpc-message``, the trailing metadata
(``retry-after-ms`` of a refusal with pushback; ``triton-request-id``
echoed on a ModelInfer that carried it, as the reference's servicer
does).  A failure before any message is trailers-only.  A message over
``--max-request-bytes`` is refused RESOURCE_EXHAUSTED from its 5-byte
prefix, before its body is buffered; whatever the client still sends
after an answer is read and dropped (its bytes go back to the
connection's window) until the client ends the stream, or for
:data:`DRAIN_S` seconds, after which RST_STREAM NO_ERROR ends it.

Drain and stop: :meth:`GrpcH2Server.goaway` sends GOAWAY (the last
stream id) on every connection; the streams in flight finish and then
each connection closes.  Calls in flight count in the server's
``exchange()``, so the CLI's drain waits for their answers as it does for
HTTP, and ``close_connections`` cuts the open connections.  With
``reuse_port`` the port is bound with ``SO_REUSEPORT`` (``--frontends``).
"""

from __future__ import annotations

import socket
import socketserver
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..protocol import h2
from ..protocol.grpc_web import frame_header, percent_encode
from ..protocol.service import METHODS, SERVICE_NAME, StatusCode
from .core import InferenceCore
from .grpc_server import (InferenceServicer, check_encoding,
                          request_messages, status_of, stream_responses,
                          unary_response)
from .http_server import _CountingServer
from .memory import DEFAULT_MAX_REQUEST_BYTES

__all__ = ["GrpcH2Server", "parse_timeout"]

#: the receive window of each stream, and of each connection
STREAM_WINDOW = 4 << 20
CONNECTION_WINDOW = 16 << 20
#: the streams a client may have open on one connection
MAX_CONCURRENT_STREAMS = 1024
#: the seconds an answered call reads away what its client still sends
DRAIN_S = 10.0
#: DATA bytes queued in one step (the condition is let go between steps)
_SEND_SLICE = 1 << 20
_RECV_BYTES = 1 << 18
_PREFIX = f"/{SERVICE_NAME}/"
_RESPONSE_HEADERS = ((":status", "200"), ("content-type", "application/grpc"),
                     ("grpc-accept-encoding", "identity, deflate, gzip"))
_TIMEOUT_UNITS = {"H": 3600.0, "M": 60.0, "S": 1.0, "m": 1e-3, "u": 1e-6,
                  "n": 1e-9}


def parse_timeout(value: str) -> Optional[float]:
    """``grpc-timeout`` (1-8 digits and a unit of H, M, S, m, u, n) in
    seconds; None where it is malformed."""
    value = value.strip()
    unit = _TIMEOUT_UNITS.get(value[-1:])
    digits = value[:-1]
    if unit is None or not digits.isdigit() or len(digits) > 8:
        return None
    return int(digits) * unit


class _Cancelled(ConnectionError):
    """The stream was reset, its deadline passed or its connection went."""


class _Stream:
    """One call: its request's queue of DATA, and its answer's writes."""

    def __init__(self, conn: "_Connection", sid: int,
                 headers: List[Tuple[str, str]]):
        self.conn = conn
        self.id = sid
        self.pseudo: Dict[str, str] = {}
        self.metadata: Dict[str, str] = {}
        for name, value in headers:
            target = self.pseudo if name.startswith(":") else self.metadata
            target[name] = (f"{target[name]}, {value}" if name in target
                            else value)
        self.chunks: deque = deque()
        self.remote_ended = False
        self.reset = False
        self.finished = False
        self.headers_sent = False
        self.timer: Optional[threading.Timer] = None

    # -- on the call's thread ----------------------------------------------
    def _check(self) -> None:
        if self.reset or self.finished or self.conn.dead:
            raise _Cancelled(f"stream {self.id} ended")

    def body(self):
        """The request's DATA as it arrives, each piece acknowledged as it
        is taken; _Cancelled where the stream ends first."""
        conn = self.conn
        while True:
            with conn.cond:
                while not self.chunks and not self.remote_ended:
                    self._check()
                    conn.cond.wait()
                self._check()
                if not self.chunks:
                    return
                data, n = self.chunks.popleft()
                conn.h2.acknowledge_received_data(n, self.id)
            conn.flush()
            yield data

    def send_message(self, parts, n: int) -> None:
        """One response message (its parts, ``n`` bytes in all), after the
        response's headers where they are not out yet."""
        conn = self.conn
        if not self.headers_sent:
            with conn.cond:
                self._check()
                conn.h2.send_headers(self.id, _RESPONSE_HEADERS)
                self.headers_sent = True
        data = memoryview(b"".join([frame_header(n), *parts]))
        pos = 0
        while pos < len(data):
            with conn.cond:
                while True:
                    self._check()
                    window = conn.h2.local_flow_window(self.id)
                    if window > 0:
                        break
                    conn.cond.wait()
                step = min(window, len(data) - pos, _SEND_SLICE)
                conn.h2.send_data(self.id, data[pos:pos + step])
            pos += step
            conn.flush()

    def finish(self, code: StatusCode, message: str = "",
               trailing: Optional[Dict[str, str]] = None,
               http_status: int = 200) -> None:
        """The trailers (trailers-only where no message went out)."""
        conn = self.conn
        with conn.cond:
            if self.finished or self.reset or conn.dead:
                return
            fields = [("grpc-status", str(int(code)))]
            if message:
                fields.append(("grpc-message", percent_encode(message)))
            fields += [(k, str(v)) for k, v in (trailing or {}).items()]
            if not self.headers_sent:
                head = list(_RESPONSE_HEADERS)
                head[0] = (":status", str(http_status))
                fields = head + fields
                self.headers_sent = True
            conn.h2.send_headers(self.id, fields, end_stream=True)
            self.finished = True
            if self.timer is not None:
                self.timer.cancel()
            # a call that waits for data or window learns it is over
            conn.cond.notify_all()
        conn.flush()

    def expire(self) -> None:
        """The call's deadline passed (a timer's thread)."""
        self.finish(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded")

    def drain(self) -> None:
        """Read away what the client still sends after the answer, for up
        to DRAIN_S seconds; then end the stream (RST_STREAM NO_ERROR)."""
        conn = self.conn
        end = time.monotonic() + DRAIN_S
        while True:
            with conn.cond:
                while self.chunks:
                    conn.h2.acknowledge_received_data(
                        self.chunks.popleft()[1], self.id)
                left = end - time.monotonic()
                if self.remote_ended or self.reset or conn.dead:
                    break
                if left <= 0:
                    conn.h2.reset_stream(self.id, h2.ErrorCode.NO_ERROR)
                    break
                conn.cond.wait(min(left, 1.0))
            conn.flush()
        conn.flush()


class _Connection:
    """One HTTP/2 connection of the listener: read on its own thread."""

    def __init__(self, server: "GrpcH2Server", sock):
        self.server = server
        self.sock = sock
        self.h2 = h2.H2Connection(client=False, settings={
            h2.Setting.INITIAL_WINDOW_SIZE: STREAM_WINDOW,
            h2.Setting.MAX_CONCURRENT_STREAMS: MAX_CONCURRENT_STREAMS,
        }, connection_window=CONNECTION_WINDOW)
        self.cond = threading.Condition()
        self._write_lock = threading.Lock()
        self.streams: Dict[int, _Stream] = {}
        self.dead = False
        self.closing = False

    def flush(self, block: bool = True) -> None:
        """Write what is queued.  Without ``block`` nothing waits for the
        writer lock: its holder writes what is queued before it lets go."""
        while True:
            if not self._write_lock.acquire(blocking=block):
                return
            try:
                while True:
                    with self.cond:
                        data = self.h2.data_to_send()
                    if not data:
                        break
                    self.sock.sendall(data)
            except OSError:
                self._lost()
                return
            finally:
                self._write_lock.release()
            with self.cond:
                if not self.h2.has_data_to_send():
                    return

    def _lost(self) -> None:
        with self.cond:
            self.dead = True
            self.cond.notify_all()
        self._close_socket()

    def _close_socket(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # closed already

    def goaway(self) -> None:
        """GOAWAY: the streams in flight finish, then the connection
        closes."""
        with self.cond:
            if not self.h2.goaway_sent and not self.dead:
                self.h2.close_connection(h2.ErrorCode.NO_ERROR)
            self.closing = True
            idle = not self.streams
        self.flush()
        if idle:
            self._close_socket()

    def run(self) -> None:
        with self.cond:
            self.h2.initiate()
        self.flush()
        self.server._track(self, True)
        try:
            while not self.dead:
                try:
                    data = self.sock.recv(_RECV_BYTES)
                except OSError:
                    break
                if not data:
                    break
                failed = False
                with self.cond:
                    try:
                        self._handle(self.h2.receive_data(data))
                    except h2.H2ProtocolError:
                        failed = True  # GOAWAY with its code is queued
                    self.cond.notify_all()
                self.flush(block=failed)
                if failed or (self.closing and not self.streams):
                    break
        finally:
            with self.cond:
                self.dead = True
                for s in self.streams.values():
                    if s.timer is not None:
                        s.timer.cancel()
                self.cond.notify_all()
            self.server._track(self, False)

    def _handle(self, events) -> None:
        """Events of the bytes read (under the condition)."""
        for ev in events:
            if isinstance(ev, h2.HeadersReceived):
                s = self.streams.get(ev.stream_id)
                if s is None and not ev.trailers:
                    s = _Stream(self, ev.stream_id, ev.headers)
                    self.streams[ev.stream_id] = s
                    threading.Thread(target=self._call, args=(s,),
                                     daemon=True,
                                     name="tc-torch-h2-call").start()
            elif isinstance(ev, h2.DataReceived):
                s = self.streams.get(ev.stream_id)
                if s is not None:
                    s.chunks.append((ev.data, ev.flow_controlled_length))
                else:
                    self.h2.acknowledge_received_data(
                        ev.flow_controlled_length, ev.stream_id)
            elif isinstance(ev, h2.StreamEnded):
                s = self.streams.get(ev.stream_id)
                if s is not None:
                    s.remote_ended = True
            elif isinstance(ev, h2.StreamReset):
                s = self.streams.get(ev.stream_id)
                if s is not None:
                    s.reset = True
            elif isinstance(ev, h2.ConnectionTerminated):
                self.closing = True

    # -- a call, on its own thread -----------------------------------------
    def _call(self, s: _Stream) -> None:
        try:
            with self.server.exchange():
                self._serve(s)
            if not s.reset and not self.dead:
                s.drain()
        except _Cancelled:
            pass  # the client reset it, or the connection went
        finally:
            with self.cond:
                self.streams.pop(s.id, None)
                idle = self.closing and not self.streams
            if s.timer is not None:
                s.timer.cancel()
            if idle:
                self.flush()
                self._close_socket()

    def _serve(self, s: _Stream) -> None:
        method = s.pseudo.get(":path", "")
        if s.pseudo.get(":method") != "POST":
            s.finish(StatusCode.INTERNAL, "gRPC requires POST",
                     http_status=405)
            return
        content_type = s.metadata.get("content-type", "")
        if content_type.split(";", 1)[0].strip() not in (
                "application/grpc", "application/grpc+proto"):
            s.finish(StatusCode.INTERNAL,
                     f"unsupported content type {content_type}",
                     http_status=415)
            return
        if s.metadata.get("te") != "trailers":
            s.finish(StatusCode.INTERNAL, "te: trailers is required",
                     http_status=400)
            return
        name = method[len(_PREFIX):] if method.startswith(_PREFIX) else ""
        if name not in METHODS:
            s.finish(StatusCode.UNIMPLEMENTED, "Method not found!")
            return
        timeout = parse_timeout(s.metadata.get("grpc-timeout", "") or "x")
        if timeout is not None:
            s.timer = threading.Timer(timeout, s.expire)
            s.timer.daemon = True
            s.timer.start()
        servicer = self.server.servicer
        try:
            encoding = check_encoding(s.metadata)
            messages = request_messages(s.body(), encoding,
                                        servicer.max_request_bytes)
            if METHODS[name][0] == "uu":
                first = next(messages, None)
                if first is None or first[0] is not None:
                    # a message within the cap: read the body to its end
                    for _ in messages:
                        pass
                parts, n = unary_response(servicer, name, first,
                                          s.metadata)
                s.send_message(parts, n)
                rid = s.metadata.get("triton-request-id")
                s.finish(StatusCode.OK, "",
                         {"triton-request-id": rid}
                         if rid and name == "ModelInfer" else None)
            else:
                for parts, n in stream_responses(servicer, name, messages,
                                                 s.metadata):
                    s.send_message(parts, n)
                s.finish(StatusCode.OK)
        except _Cancelled:
            raise
        except Exception as e:  # noqa: BLE001 - the call's status
            s.finish(*status_of(e))


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        try:
            self.request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY,
                                    1)
        except OSError:
            pass
        _Connection(self.server, self.request).run()


class GrpcH2Server(_CountingServer):
    """The gRPC port of one :class:`InferenceCore` (``--grpc-port``):
    ``serve_forever`` on a thread, ``goaway`` to drain, ``shutdown``,
    ``close_connections`` and ``server_close`` to stop, as the HTTP
    port's ``HttpServer``.  ``tls`` (a ``tls.TLSConfig``) serves it with
    ALPN ``h2``; ``reuse_port`` binds with ``SO_REUSEPORT``."""

    def __init__(self, core: InferenceCore, host: str = "127.0.0.1",
                 port: int = 8001,
                 max_request_bytes: int = DEFAULT_MAX_REQUEST_BYTES,
                 reuse_port: bool = False, tls=None):
        self.core = core
        self.allow_reuse_port = reuse_port
        #: the ingress cap on one request message (0: none)
        self.max_request_bytes = max(0, int(max_request_bytes or 0))
        self.servicer = InferenceServicer(core, self.max_request_bytes)
        self._live: set = set()
        self._live_lock = threading.Lock()
        super().__init__((host, port), _Handler, tls=tls, grpc=True)

    def _track(self, conn: _Connection, alive: bool) -> None:
        with self._live_lock:
            (self._live.add if alive else self._live.discard)(conn)

    def goaway(self) -> None:
        """GOAWAY on every connection: the calls in flight finish, no new
        stream is taken, and each connection closes once idle."""
        with self._live_lock:
            conns = list(self._live)
        for conn in conns:
            conn.goaway()
