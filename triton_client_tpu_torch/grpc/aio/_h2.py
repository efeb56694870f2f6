"""gRPC over HTTP/2 for the asyncio client: the sync client's wire
(``grpc/_h2_transport.py``) on ``asyncio`` streams.

The connection is the same sans-IO one (``protocol/h2.py``), read by a
task of its own: unary calls and ``stream_infer`` multiplex on it as
streams, a sender waits on an event for window, and a stream's messages
are acknowledged (WINDOW_UPDATE) as the consumer takes them.  The
deadline travels as ``grpc-timeout``; where it passes the stream is reset
and the call fails with DEADLINE_EXCEEDED.  GOAWAY or a broken
connection fails the calls in flight with UNAVAILABLE (a unary call the
server never processed is sent once more on a new connection), and the
next call opens a new connection.  :func:`select_transport` makes the
sync client's choice: HTTP/2 first, gRPC-Web where the peer answers in
HTTP/1.1 or its TLS does not negotiate ``h2``,
``TC_TPU_GRPC_TRANSPORT=h2|web`` pinning it.
"""

from __future__ import annotations

import asyncio
import os
from typing import Dict, Optional

from ...protocol import h2
from ...protocol.service import StatusCode, path
from .._h2_transport import (_RESERVED, CONNECTION_WINDOW, STREAM_WINDOW,
                             TRANSPORT_ENV, ClientEvents, NotHttp2, _Call,
                             _answer, _split, judge_first_bytes)
from .._transport import RpcError

__all__ = ["AioH2Transport", "select_transport"]

_RECV_BYTES = 1 << 18
#: DATA bytes written before the writer is drained
_SEND_SLICE = 1 << 20


class _AioCall(_Call):
    """A call of the asyncio connection: its end is an event, a stream's
    messages a queue."""

    def __init__(self, sid: int, stream: bool):
        super().__init__(sid)
        self.done = asyncio.Event()
        self.queue: Optional[asyncio.Queue] = (asyncio.Queue() if stream
                                               else None)

    @property
    def streaming(self) -> bool:
        return self.queue is not None

    def deliver(self, payload: bytes, owed: int) -> None:
        self.queue.put_nowait((payload, owed))

    def fail(self, code, message, refused=False) -> None:
        if self.complete:
            return
        super().fail(code, message, refused)
        self.done.set()
        if self.queue is not None:
            self.queue.put_nowait(None)


class _AioConnection(ClientEvents):
    def __init__(self, reader, writer, authority: str, scheme: str):
        self.reader, self.writer = reader, writer
        self.authority, self.scheme = authority, scheme
        self.h2 = h2.H2Connection(client=True, settings={
            h2.Setting.INITIAL_WINDOW_SIZE: STREAM_WINDOW,
        }, connection_window=CONNECTION_WINDOW)
        self.calls: Dict[int, _AioCall] = {}
        self.dead = False
        self.goaway_last: Optional[int] = None
        self.changed = asyncio.Event()  # window, settings or an end
        self._task: Optional[asyncio.Task] = None

    @classmethod
    async def open(cls, host: str, port: int, authority: str,
                   ssl_context=None, timeout: float = 60.0):
        if ssl_context is not None:
            ssl_context.set_alpn_protocols(["h2", "http/1.1"])
        try:
            reader, writer = await asyncio.wait_for(asyncio.open_connection(
                host, port, ssl=ssl_context,
                server_hostname=host if ssl_context is not None else None),
                timeout)
        except (OSError, asyncio.TimeoutError) as e:
            raise RpcError(StatusCode.UNAVAILABLE, f"failed to connect: {e}")
        conn = cls(reader, writer, authority,
                   "https" if ssl_context is not None else "http")
        try:
            if ssl_context is not None:
                tls = writer.get_extra_info("ssl_object")
                if tls is None or tls.selected_alpn_protocol() != "h2":
                    raise NotHttp2("TLS did not negotiate ALPN h2")
            conn.h2.initiate()
            writer.write(conn.h2.data_to_send())
            first = b""
            while len(first) < 9:
                chunk = await asyncio.wait_for(reader.read(_RECV_BYTES),
                                               timeout)
                if not chunk:
                    break
                first += chunk
            conn.h2.receive_data(judge_first_bytes(first))
            conn._flush()
        except NotHttp2:
            writer.close()
            raise
        except (OSError, asyncio.TimeoutError, h2.H2ProtocolError) as e:
            writer.close()
            raise RpcError(StatusCode.UNAVAILABLE, f"failed to connect: {e}")
        conn._task = asyncio.ensure_future(conn._read())
        return conn

    def usable(self) -> bool:
        return not self.dead and self.goaway_last is None

    def _flush(self) -> None:
        data = self.h2.data_to_send()
        if data and not self.dead:
            self.writer.write(data)

    def start(self, method: str, headers: Dict[str, str],
              timeout: Optional[float], stream: bool = False) -> _AioCall:
        if not self.usable() or not self.h2.can_open_stream():
            raise RpcError(StatusCode.UNAVAILABLE,
                           "the connection is going away")
        fields = [(":method", "POST"), (":scheme", self.scheme),
                  (":path", path(method)), (":authority", self.authority),
                  ("content-type", "application/grpc"), ("te", "trailers"),
                  ("user-agent", "tc-torch-grpc-aio")]
        if timeout is not None:
            fields.append(("grpc-timeout",
                           f"{min(max(1, int(timeout * 1e6)), 99999999)}u"))
        fields += [(k.lower(), str(v)) for k, v in headers.items()
                   if k.lower() not in _RESERVED and not k.startswith(":")]
        sid = self.h2.get_next_available_stream_id()
        call = _AioCall(sid, stream)
        self.calls[sid] = call
        self.h2.send_headers(sid, fields)
        self._flush()
        return call

    async def send(self, call: _AioCall, data,
                   end_stream: bool = False) -> None:
        view = memoryview(data)
        pos = 0
        while True:
            if call.complete or self.dead:
                raise RpcError(StatusCode.UNAVAILABLE,
                               call.message or "the stream ended")
            window = self.h2.local_flow_window(call.id)
            if window <= 0 and pos < len(view):
                self.changed.clear()
                await self.changed.wait()
                continue
            step = min(window, len(view) - pos, _SEND_SLICE)
            last = pos + step == len(view)
            self.h2.send_data(call.id, view[pos:pos + step],
                              end_stream=end_stream and last)
            self._flush()
            await self.writer.drain()
            pos += step
            if last:
                return

    def reset(self, call: _AioCall, code: StatusCode, message: str) -> None:
        if not call.complete and not self.dead:
            self.h2.reset_stream(call.id, h2.ErrorCode.CANCEL)
            self._flush()
        call.fail(code, message)
        self.calls.pop(call.id, None)

    async def messages(self, call: _AioCall):
        """A stream's messages, each acknowledged once taken."""
        while True:
            item = await call.queue.get()
            if item is None:
                call.queue.put_nowait(None)
                return
            payload, owed = item
            if owed and not self.dead:
                self.h2.acknowledge_received_data(owed, call.id)
                self._flush()
            yield payload

    async def _read(self) -> None:
        reason = "the server closed the connection"
        try:
            while True:
                data = await self.reader.read(_RECV_BYTES)
                if not data:
                    break
                self._handle(self.h2.receive_data(data))
                self._flush()
                self.changed.set()
        except h2.H2ProtocolError as e:
            reason = f"protocol error: {e}"
            self._flush()
        except (OSError, asyncio.IncompleteReadError) as e:
            reason = f"the connection broke: {e}"
        finally:
            self._lost(reason)

    def _lost(self, message: str) -> None:
        self.dead = True
        for call in list(self.calls.values()):
            call.fail(StatusCode.UNAVAILABLE, message)
        self.calls.clear()
        self.changed.set()
        self.writer.close()

    async def close(self) -> None:
        if not self.dead:
            self.h2.close_connection(h2.ErrorCode.NO_ERROR)
            self._flush()
        self._lost("the client closed the connection")
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass  # the reader's end is the connection's end


class AioH2Transport:
    """The asyncio client's calls over one HTTP/2 connection at a time."""

    name = "h2"

    def __init__(self, url: str, ssl_context=None,
                 connect_timeout: float = 60.0):
        self._host, self._port = _split(url)
        self._authority = url
        self._ssl = ssl_context
        self._timeout = connect_timeout
        self._conn: Optional[_AioConnection] = None
        self._lock = asyncio.Lock()

    async def connection(self) -> _AioConnection:
        async with self._lock:
            conn = self._conn
            if conn is None or not conn.usable():
                if conn is not None and not conn.calls:
                    await conn.close()
                self._conn = conn = await _AioConnection.open(
                    self._host, self._port, self._authority, self._ssl,
                    self._timeout)
            return conn

    async def unary(self, method: str, frame: bytes, response_type,
                    headers: dict, timeout: Optional[float] = None,
                    sizes: Optional[list] = None):
        for attempt in (1, 2):
            try:
                conn = await self.connection()
            except NotHttp2 as e:
                raise RpcError(StatusCode.UNAVAILABLE,
                               f"failed to connect: {e}")
            call = conn.start(method, headers, timeout)
            try:
                async with asyncio.timeout(timeout):
                    try:
                        await conn.send(call, frame, end_stream=True)
                    except RpcError:
                        pass  # the call's status says why
                    await call.done.wait()
            except TimeoutError:
                conn.reset(call, StatusCode.DEADLINE_EXCEEDED,
                           "Deadline Exceeded")
                raise RpcError(StatusCode.DEADLINE_EXCEEDED,
                               "Deadline Exceeded")
            except asyncio.CancelledError:
                conn.reset(call, StatusCode.CANCELLED,
                           "Locally cancelled by application!")
                raise
            if call.refused and attempt == 1:
                continue
            return _answer(call, response_type, sizes)
        raise RpcError(call.code, call.message)

    async def close(self) -> None:
        conn, self._conn = self._conn, None
        if conn is not None:
            await conn.close()


async def select_transport(url: str, ssl_context=None,
                           connect_timeout: float = 60.0):
    """An :class:`AioH2Transport` where the peer speaks HTTP/2, else None
    (gRPC-Web); ``TC_TPU_GRPC_TRANSPORT`` pins it (``h2``: an error
    where the peer does not)."""
    pin = os.environ.get(TRANSPORT_ENV, "").strip().lower()
    if pin == "web":
        return None
    transport = AioH2Transport(url, ssl_context, connect_timeout)
    try:
        await transport.connection()
    except NotHttp2 as e:
        if pin == "h2":
            raise RpcError(StatusCode.UNAVAILABLE,
                           f"{TRANSPORT_ENV}=h2, but {url} does not speak "
                           f"HTTP/2: {e}")
        return None
    return transport
