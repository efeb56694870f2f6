"""gRPC over HTTP/2 on the client: the port's gRPC calls on the wire a
real Triton server (and the port's own gRPC port) serves.

One HTTP/2 connection per client (``protocol/h2.py``, sans I/O, driven
here with a reader thread): unary calls, ``async_infer``, ``infer_many``
and the stream all multiplex on it as streams.  A request is HEADERS
(``:method POST``, ``:path /inference.GRPCInferenceService/<Method>``,
``content-type application/grpc``, ``te: trailers``, the deadline as
``grpc-timeout``, the call's metadata) and DATA frames of the length-
prefixed message (compressed under ``grpc-encoding`` by the caller);
an answer is HEADERS, DATA and trailers (``grpc-status``, a
percent-encoded ``grpc-message``, trailing metadata), or trailers only.
A sender waits on the connection's condition for window, never past
the peer's; received DATA is acknowledged as it is consumed.

* :func:`select_transport` chooses the wire as the reference's native
  client does (``native/client/grpc_client.cc:366-400``): the HTTP/2
  preface goes first, and where the peer answers in HTTP/1.1 (the port's
  HTTP port, the reference's bridge) or its TLS does not negotiate ALPN
  ``h2``, the calls go as gRPC-Web (``_transport.WebTransport``).
  ``TC_TPU_GRPC_TRANSPORT=h2|web`` pins the choice; a pinned ``h2`` that
  the peer does not speak is an error, never a quiet fallback.  A peer
  that cannot be reached is UNAVAILABLE and pins nothing.
* The deadline: the call's remaining time travels as ``grpc-timeout``;
  where it passes, the stream is reset (CANCEL) and the call fails with
  DEADLINE_EXCEEDED.
* GOAWAY, or a connection that breaks, fails the calls in flight with
  UNAVAILABLE; the next call opens a new connection.  A unary call the
  server never processed (above GOAWAY's last stream id, or refused with
  REFUSED_STREAM) is sent once more on a new connection: it did not run.
  Past that, the client's retry policy decides, as it does for gRPC-Web.
* ``keepalive_options`` (the reference's ``KeepAliveOptions``) drive
  PINGs, as the reference's channel options do: every
  ``keepalive_time_ms`` while calls are open (always, with
  ``keepalive_permit_without_calls``), at most
  ``http2_max_pings_without_data`` of them (0: no bound) between two
  sends of headers or data; a PING unanswered after
  ``keepalive_timeout_ms`` closes the connection (UNAVAILABLE).
* TLS: the client's context (``_client.channel_ssl_context``) with ALPN
  ``h2`` offered beside ``http/1.1``.
* Each stream's receive window is 4 MiB, or grpcio's
  ``grpc.http2.lookahead_bytes`` channel argument where the client is
  given it (``channel_args``); the connection's is 16 MiB.
* A stream's answers reach ``on_message`` on a thread of the stream's own,
  in order: a callback that sends on the stream may wait for window while
  the connection's reader goes on.
"""

from __future__ import annotations

import os
import queue
import socket
import threading
import time
import urllib.parse
from typing import Callable, Dict, List, Optional, Tuple

from ..protocol import h2
from ..protocol.grpc_web import iter_frames
from ..protocol.service import StatusCode, path
from ._transport import RpcError, WebTransport, http_error

__all__ = ["H2Transport", "NotHttp2", "TRANSPORT_ENV", "select_transport"]

#: pins the client's wire: ``h2`` or ``web`` (unset: try HTTP/2 first)
TRANSPORT_ENV = "TC_TPU_GRPC_TRANSPORT"
#: the receive window of each stream, and of the connection
STREAM_WINDOW = 4 << 20
CONNECTION_WINDOW = 16 << 20
#: DATA bytes queued in one step (the condition is let go between steps)
_SEND_SLICE = 1 << 20
_RECV_BYTES = 1 << 18
#: the keepalive interval that means "never" (the reference's default)
_NEVER_MS = 2 ** 31 - 1

#: a stream reset by the server, as the call's status (gRPC's HTTP/2 map)
_RESET_STATUS = {
    h2.ErrorCode.REFUSED_STREAM: StatusCode.UNAVAILABLE,
    h2.ErrorCode.CANCEL: StatusCode.CANCELLED,
    h2.ErrorCode.ENHANCE_YOUR_CALM: StatusCode.RESOURCE_EXHAUSTED,
    h2.ErrorCode.INADEQUATE_SECURITY: StatusCode.PERMISSION_DENIED,
}


class NotHttp2(Exception):
    """The peer does not speak HTTP/2: it answered the preface in HTTP/1.x,
    or its TLS did not negotiate ALPN ``h2``."""


class _GoingAway(RpcError):
    """A call could not start: its connection is going away."""


def _split(url: str) -> Tuple[str, int]:
    host, _, port = url.rpartition(":")
    if not host:
        return url, 80
    return host.strip("[]"), int(port)


class _Call:
    """One stream of the connection, a unary call's or a duplex one's."""

    def __init__(self, sid: int, on_message=None, on_end=None):
        self.id = sid
        self.http_status = 0
        self.headers: Dict[str, str] = {}
        self.trailers: Optional[Dict[str, str]] = None
        self.data: List[bytes] = []
        self.complete = False
        self.code = StatusCode.OK
        self.message = ""
        self.refused = False  # never processed by the server
        self.on_message = on_message
        self.on_end = on_end
        self.buf = bytearray()
        # a stream's answers, in order, for its dispatcher thread
        self.inbox: Optional[queue.Queue] = (
            queue.Queue() if on_message is not None else None)

    @property
    def streaming(self) -> bool:
        """A duplex call, whose messages are delivered one by one."""
        return self.inbox is not None

    def deliver(self, payload: bytes, owed: int) -> None:
        """One message of a stream (``owed``: the flow-controlled bytes to
        acknowledge once it is consumed)."""
        self.inbox.put((payload, owed))

    def fail(self, code: StatusCode, message: str,
             refused: bool = False) -> None:
        if self.complete:
            return
        self.complete = True
        self.code, self.message, self.refused = code, message, refused
        if self.inbox is not None:
            self.inbox.put(None)

    def end(self) -> None:
        """The server ended the stream: the call's status."""
        if self.complete:
            return
        fields = self.trailers if self.trailers is not None else \
            self.headers
        if self.http_status != 200:
            err = http_error(self.http_status,
                             b"".join(self.data) if self.data else b"")
            self.fail(err.code(), err.details())
            return
        raw = fields.get("grpc-status")
        if raw is None:
            self.fail(StatusCode.UNKNOWN, "missing grpc-status")
            return
        try:
            code = StatusCode.of(int(raw))
        except ValueError:
            code = StatusCode.UNKNOWN
        self.fail(code, urllib.parse.unquote(fields.get("grpc-message",
                                                        "")))

    def trailing(self) -> Dict[str, str]:
        fields = self.trailers if self.trailers is not None else \
            self.headers
        return {k: v for k, v in fields.items()
                if k not in ("grpc-status", "grpc-message")
                and not k.startswith(":")}


class ClientEvents:
    """What a client's connection makes of the events of the bytes it
    read: its ``calls`` (by stream id) take their headers, data, end or
    reset; GOAWAY fails the calls above its last stream id.  The sync and
    the asyncio connections share it."""

    calls: Dict[int, _Call]
    goaway_last: Optional[int] = None

    def _ping_acked_event(self) -> None:
        """A PING was answered (the keepalive's concern)."""

    def _handle(self, events) -> None:
        for ev in events:
            call = self.calls.get(getattr(ev, "stream_id", -1))
            if isinstance(ev, h2.HeadersReceived):
                if call is None:
                    continue
                fields = dict(ev.headers)
                if ev.trailers:
                    call.trailers = fields
                else:
                    call.headers = fields
                    try:
                        call.http_status = int(fields.get(":status", "0"))
                    except ValueError:
                        call.http_status = 0
            elif isinstance(ev, h2.DataReceived):
                owed = ev.flow_controlled_length
                if call is not None and call.streaming:
                    call.buf += ev.data
                    for _flags, payload in _take_messages(call.buf):
                        call.deliver(payload, owed)
                        owed = 0
                elif call is not None:
                    call.data.append(ev.data)
                if owed:
                    self.h2.acknowledge_received_data(owed, ev.stream_id)
            elif isinstance(ev, h2.StreamEnded):
                if call is not None:
                    if call.streaming and call.buf:
                        call.fail(StatusCode.INTERNAL,
                                  "the stream ended inside a message")
                    call.end()
                    self.calls.pop(call.id, None)
            elif isinstance(ev, h2.StreamReset):
                if call is not None:
                    try:
                        name = h2.ErrorCode(ev.error_code).name
                    except ValueError:
                        name = str(ev.error_code)
                    call.fail(_RESET_STATUS.get(ev.error_code,
                                                StatusCode.INTERNAL),
                              f"stream reset by the server ({name})",
                              refused=ev.error_code
                              == h2.ErrorCode.REFUSED_STREAM)
                    self.calls.pop(call.id, None)
            elif isinstance(ev, h2.ConnectionTerminated):
                self.goaway_last = ev.last_stream_id
                for sid, c in list(self.calls.items()):
                    if sid > ev.last_stream_id:
                        c.fail(StatusCode.UNAVAILABLE,
                               "the server went away (GOAWAY) before "
                               "processing the call", refused=True)
                        self.calls.pop(sid, None)
            elif isinstance(ev, h2.PingAckReceived):
                self._ping_acked_event()


class _Connection(ClientEvents):
    """One HTTP/2 connection to the server, read on its own thread."""

    def __init__(self, host: str, port: int, authority: str,
                 ssl_context=None, keepalive=None,
                 connect_timeout: float = 60.0,
                 stream_window: int = STREAM_WINDOW):
        self.authority = authority
        self.scheme = "https" if ssl_context is not None else "http"
        try:
            sock = socket.create_connection((host, port),
                                            timeout=connect_timeout)
        except OSError as e:
            raise RpcError(StatusCode.UNAVAILABLE, f"failed to connect: {e}")
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if ssl_context is not None:
                ssl_context.set_alpn_protocols(["h2", "http/1.1"])
                sock = ssl_context.wrap_socket(sock, server_hostname=host)
                if sock.selected_alpn_protocol() != "h2":
                    raise NotHttp2("TLS did not negotiate ALPN h2")
            self.h2 = h2.H2Connection(client=True, settings={
                h2.Setting.INITIAL_WINDOW_SIZE: stream_window,
            }, connection_window=CONNECTION_WINDOW)
            self.h2.initiate()
            sock.sendall(self.h2.data_to_send())
            first = first_bytes(sock.recv)
            events = self.h2.receive_data(first)
        except NotHttp2:
            sock.close()
            raise
        except (OSError, h2.H2ProtocolError) as e:
            sock.close()
            raise RpcError(StatusCode.UNAVAILABLE, f"failed to connect: {e}")
        sock.settimeout(None)
        self.sock = sock
        self.cond = threading.Condition()
        self._write_lock = threading.Lock()
        self.calls: Dict[int, _Call] = {}
        self.dead = False
        self.goaway_last: Optional[int] = None
        self._sends_since_ping = 0
        self._ping_acked = threading.Event()
        with self.cond:
            self._handle(events)
        self.flush()
        self._reader = threading.Thread(target=self._read, daemon=True,
                                        name="tc-torch-h2-reader")
        self._reader.start()
        if keepalive is not None and \
                keepalive.keepalive_time_ms < _NEVER_MS:
            threading.Thread(target=self._keepalive, args=(keepalive,),
                             daemon=True, name="tc-torch-h2-ping").start()

    # -- writing -------------------------------------------------------------
    def flush(self, block: bool = True) -> None:
        """Write what is queued (see ``server/grpc_h2.py``'s)."""
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
            except OSError as e:
                self._lost(f"the connection broke: {e}")
                return
            finally:
                self._write_lock.release()
            with self.cond:
                if not self.h2.has_data_to_send():
                    return

    def usable(self) -> bool:
        return not self.dead and self.goaway_last is None

    def start(self, method: str, headers: Dict[str, str],
              deadline: Optional[float], on_message=None,
              on_end=None) -> _Call:
        """Open a stream: HEADERS of ``method`` with ``headers`` as its
        metadata.  Waits for the peer's MAX_CONCURRENT_STREAMS."""
        fields = [(":method", "POST"), (":scheme", self.scheme),
                  (":path", path(method)), (":authority", self.authority),
                  ("content-type", "application/grpc"), ("te", "trailers"),
                  ("user-agent", "tc-torch-grpc")]
        if deadline is not None:
            left_us = max(1, int((deadline - time.monotonic()) * 1e6))
            fields.append(("grpc-timeout", f"{min(left_us, 99999999)}u"))
        for k, v in headers.items():
            k = k.lower()
            if k in _RESERVED or k.startswith(":"):
                continue
            fields.append((k, str(v)))
        with self.cond:
            while True:
                if not self.usable():
                    raise _GoingAway(StatusCode.UNAVAILABLE,
                                     "the connection is going away")
                if self.h2.can_open_stream():
                    break
                if not self.cond.wait(_left(deadline)):
                    raise RpcError(StatusCode.DEADLINE_EXCEEDED,
                                   "Deadline Exceeded")
            sid = self.h2.get_next_available_stream_id()
            call = _Call(sid, on_message, on_end)
            self.calls[sid] = call
            self.h2.send_headers(sid, fields)
            self._sends_since_ping = 0
        self.flush()
        return call

    def send(self, call: _Call, data, end_stream: bool = False,
             deadline: Optional[float] = None) -> None:
        """DATA on ``call``'s stream, waiting for window as it goes (until
        ``deadline``: then DEADLINE_EXCEEDED)."""
        view = memoryview(data)
        pos = 0
        while True:
            with self.cond:
                while True:
                    if call.complete or self.dead:
                        raise RpcError(StatusCode.UNAVAILABLE,
                                       call.message or "the stream ended")
                    window = self.h2.local_flow_window(call.id)
                    if window > 0 or pos == len(view):
                        break
                    left = _left(deadline)
                    if left is not None and left <= 0:
                        raise RpcError(StatusCode.DEADLINE_EXCEEDED,
                                       "Deadline Exceeded")
                    self.cond.wait(left)
                step = min(window, len(view) - pos, _SEND_SLICE)
                last = pos + step == len(view)
                self.h2.send_data(call.id, view[pos:pos + step],
                                  end_stream=end_stream and last)
                self._sends_since_ping = 0
            pos += step
            self.flush()
            if last:
                return

    def reset(self, call: _Call, code: StatusCode, message: str) -> None:
        """End ``call`` from this side (RST_STREAM CANCEL)."""
        with self.cond:
            if not call.complete:
                self.h2.reset_stream(call.id, h2.ErrorCode.CANCEL)
                call.fail(code, message)
                self.calls.pop(call.id, None)
            self.cond.notify_all()
        self.flush()

    def wait(self, call: _Call, deadline: Optional[float]) -> bool:
        with self.cond:
            while not call.complete:
                left = _left(deadline)
                if left is not None and left <= 0:
                    return False
                self.cond.wait(left)
        return True

    def close(self) -> None:
        """GOAWAY, then the socket closed: the calls in flight fail."""
        with self.cond:
            if not self.dead:
                self.h2.close_connection(h2.ErrorCode.NO_ERROR)
        self.flush()
        self._lost("the client closed the connection")

    def _lost(self, message: str) -> None:
        with self.cond:
            self.dead = True
            for call in list(self.calls.values()):
                call.fail(StatusCode.UNAVAILABLE, message)
                self.calls.pop(call.id, None)
            self.cond.notify_all()
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass

    # -- reading -------------------------------------------------------------
    def _read(self) -> None:
        reason = "the server closed the connection"
        try:
            while True:
                data = self.sock.recv(_RECV_BYTES)
                if not data:
                    break
                with self.cond:
                    self._handle(self.h2.receive_data(data))
                    self.cond.notify_all()
                self.flush(block=False)
        except h2.H2ProtocolError as e:
            reason = f"protocol error: {e}"
            self.flush()
        except OSError as e:
            reason = f"the connection broke: {e}"
        finally:
            self._lost(reason)

    def _ping_acked_event(self) -> None:
        self._ping_acked.set()

    # -- keepalive -------------------------------------------------------------
    def _keepalive(self, opts) -> None:
        interval = opts.keepalive_time_ms / 1000.0
        timeout = opts.keepalive_timeout_ms / 1000.0
        limit = opts.http2_max_pings_without_data
        while True:
            time.sleep(interval)
            with self.cond:
                if self.dead:
                    return
                idle = not self.calls
                if (idle and not opts.keepalive_permit_without_calls) or (
                        limit and self._sends_since_ping >= limit):
                    continue
                self._ping_acked.clear()
                self.h2.ping(os.urandom(8))
                self._sends_since_ping += 1
            self.flush()
            if not self._ping_acked.wait(timeout):
                self._lost("keepalive ping not answered")
                return


#: request headers the transport sets itself
_RESERVED = frozenset(("content-type", "te", "host", "connection",
                       "content-length", "transfer-encoding", "keep-alive",
                       "upgrade", "user-agent", "grpc-timeout"))


def looks_like_settings(head: bytes) -> bool:
    """Whether 9 bytes are the header of a server's first frame: SETTINGS
    (not an ACK) on stream 0, whole settings long."""
    n = int.from_bytes(head[:3], "big")
    return (head[3] == h2.SETTINGS and head[4] == 0
            and head[5:9] == b"\0\0\0\0" and n % 6 == 0)


def first_bytes(recv) -> bytes:
    """The peer's first bytes after the preface, ``recv(n)`` reading
    them (:func:`judge_first_bytes`)."""
    got = b""
    while len(got) < 9:
        chunk = recv(_RECV_BYTES)
        if not chunk:
            break
        got += chunk
    return judge_first_bytes(got)


def judge_first_bytes(got: bytes) -> bytes:
    """``got`` where it begins with an HTTP/2 server's SETTINGS, else
    NotHttp2 (an HTTP/1.x status line, or the body a server that takes
    the preface for an HTTP/0.9 request sends); ConnectionError where the
    server closed at once."""
    if len(got) >= 9 and looks_like_settings(got):
        return got
    if not got:
        raise ConnectionError("the server closed the connection")
    raise NotHttp2("the server answered in HTTP/1.x"
                   if got.startswith(b"HTT") else
                   "the server's first bytes are not HTTP/2 SETTINGS")


def _left(deadline: Optional[float]) -> Optional[float]:
    return None if deadline is None else deadline - time.monotonic()


def _take_messages(buf: bytearray):
    """The whole length-prefixed messages at the front of ``buf``, taken
    out of it."""
    pos = 0
    out = []
    while len(buf) - pos >= 5:
        n = int.from_bytes(buf[pos + 1:pos + 5], "big")
        if len(buf) - pos - 5 < n:
            break
        out.append((buf[pos], bytes(buf[pos + 5:pos + 5 + n])))
        pos += 5 + n
    del buf[:pos]
    return out


class H2StreamCall:
    """A duplex call on the client's connection, with the interface of
    ``_transport.StreamCall``: ``send``, ``close_send``, ``cancel``,
    ``join``, ``close``; ``on_message(payload)`` runs on the stream's
    dispatcher thread, ``on_end(code, message)`` once, last."""

    def __init__(self, conn: _Connection, method: str, headers: dict,
                 on_message: Callable[[bytes], None],
                 on_end: Callable[[StatusCode, str], None],
                 deadline_s: Optional[float] = None):
        self._conn = conn
        self._deadline = (time.monotonic() + deadline_s
                          if deadline_s is not None else None)
        self._call = conn.start(method, headers, self._deadline,
                                on_message, on_end)
        self._timer = None
        if deadline_s is not None:
            self._timer = threading.Timer(deadline_s, self._expire)
            self._timer.daemon = True
            self._timer.start()
        self._dispatcher = threading.Thread(target=self._dispatch,
                                            daemon=True,
                                            name="tc-torch-grpc-stream")
        self._dispatcher.start()

    def _dispatch(self) -> None:
        call = self._call
        try:
            while True:
                item = call.inbox.get()
                if item is None:
                    break
                payload, owed = item
                try:
                    call.on_message(payload)
                finally:
                    if owed:
                        with self._conn.cond:
                            self._conn.h2.acknowledge_received_data(
                                owed, call.id)
                        self._conn.flush(block=False)
        finally:
            if self._timer is not None:
                self._timer.cancel()
            call.on_end(call.code, call.message)

    def _expire(self) -> None:
        self._conn.reset(self._call, StatusCode.DEADLINE_EXCEEDED,
                         "Deadline Exceeded")

    def send(self, frame: bytes) -> None:
        try:
            self._conn.send(self._call, frame)
        except RpcError as e:
            raise RpcError(StatusCode.UNAVAILABLE,
                           f"the stream's connection broke: "
                           f"{e.details()}")

    def close_send(self) -> None:
        try:
            self._conn.send(self._call, b"", end_stream=True)
        except RpcError:
            pass  # the stream ended: on_end reports it

    def cancel(self) -> None:
        self._conn.reset(self._call, StatusCode.CANCELLED,
                         "Locally cancelled by application!")

    def join(self, timeout: Optional[float] = None) -> bool:
        self._dispatcher.join(timeout)
        return not self._dispatcher.is_alive()

    def close(self) -> None:
        pass  # the connection is the client's


class H2Transport:
    """The client's calls over one HTTP/2 connection at a time (a new one
    where the last went away)."""

    name = "h2"

    def __init__(self, url: str, ssl_context=None, keepalive=None,
                 connect_timeout: float = 60.0,
                 stream_window: int = STREAM_WINDOW):
        self._host, self._port = _split(url)
        self._authority = url
        self._ssl = ssl_context
        self._keepalive = keepalive
        self._stream_window = stream_window
        self._connect_timeout = connect_timeout
        self._lock = threading.Lock()
        self._conn: Optional[_Connection] = None
        self._connection()  # NotHttp2 / RpcError here pin nothing

    def _connection(self, fresh: bool = False) -> _Connection:
        with self._lock:
            conn = self._conn
            if fresh or conn is None or not conn.usable():
                if conn is not None and not conn.dead and not conn.calls:
                    conn.close()
                self._conn = conn = _Connection(
                    self._host, self._port, self._authority, self._ssl,
                    self._keepalive, self._connect_timeout,
                    self._stream_window)
            return conn

    def unary(self, method: str, frame: bytes, response_type,
              headers: dict, timeout: Optional[float] = None,
              sizes: Optional[list] = None):
        """One unary call: its decoded response, or RpcError.  A call the
        server never processed is sent once more on a new connection."""
        deadline = time.monotonic() + timeout if timeout is not None \
            else None
        for attempt in (1, 2):
            try:
                conn = self._connection()
                call = conn.start(method, headers, deadline)
            except NotHttp2 as e:
                raise RpcError(StatusCode.UNAVAILABLE,
                               f"failed to connect: {e}")
            except _GoingAway:
                if attempt == 1:
                    continue
                raise
            try:
                conn.send(call, frame, end_stream=True, deadline=deadline)
            except RpcError:
                pass  # the call's status (or its deadline) says why
            if not conn.wait(call, deadline):
                conn.reset(call, StatusCode.DEADLINE_EXCEEDED,
                           "Deadline Exceeded")
                raise RpcError(StatusCode.DEADLINE_EXCEEDED,
                               "Deadline Exceeded")
            if call.refused and attempt == 1:
                continue
            return _answer(call, response_type, sizes)
        raise RpcError(call.code, call.message)

    def open_stream(self, method: str, headers: dict, on_message,
                    on_end, deadline_s: Optional[float] = None):
        try:
            return H2StreamCall(self._connection(), method, headers,
                                on_message, on_end, deadline_s)
        except NotHttp2 as e:
            raise RpcError(StatusCode.UNAVAILABLE, f"failed to connect: {e}")

    def close(self) -> None:
        with self._lock:
            conn, self._conn = self._conn, None
        if conn is not None:
            conn.close()


def _answer(call: _Call, response_type, sizes: Optional[list]):
    if call.code != StatusCode.OK:
        raise RpcError(call.code, call.message, call.trailing())
    try:
        frames = list(iter_frames([b"".join(call.data)]))
    except ValueError as e:
        raise RpcError(StatusCode.INTERNAL, str(e))
    if not frames:
        raise RpcError(StatusCode.INTERNAL, "missing response message")
    if sizes is not None:
        sizes.append(len(frames[0][1]))
    return response_type.FromString(frames[0][1])


def stream_window_of(channel_args) -> int:
    """The receive window of each stream: grpcio's
    ``grpc.http2.lookahead_bytes`` channel argument where given."""
    for key, value in channel_args or ():
        if key == "grpc.http2.lookahead_bytes":
            return max(1, min(int(value), h2.MAX_WINDOW))
    return STREAM_WINDOW


def select_transport(url: str, pool_factory, ssl_context=None,
                     keepalive=None, connect_timeout: float = 60.0,
                     channel_args=None):
    """The client's wire: HTTP/2 where the peer speaks it, else gRPC-Web
    on ``pool_factory()``'s pool; ``TC_TPU_GRPC_TRANSPORT`` pins it."""
    pin = os.environ.get(TRANSPORT_ENV, "").strip().lower()
    if pin == "web":
        return WebTransport(url, pool_factory(), ssl_context)
    try:
        return H2Transport(url, ssl_context, keepalive, connect_timeout,
                           stream_window_of(channel_args))
    except NotHttp2 as e:
        if pin == "h2":
            raise RpcError(StatusCode.UNAVAILABLE,
                           f"{TRANSPORT_ENV}=h2, but {url} does not speak "
                           f"HTTP/2: {e}")
        return WebTransport(url, pool_factory(), ssl_context)
