"""An HTTP/2 connection without I/O (RFC 9113), for the port's gRPC
listener (``server/grpc_h2.py``) and its clients (``grpc/_h2_transport.py``).

Bytes that arrive go in through :meth:`H2Connection.receive_data`, which
returns what they meant as events; calls (``send_headers``,
``send_data``, ``reset_stream``, ``ping``, ``close_connection``, ...)
queue frames, which :meth:`H2Connection.data_to_send` hands out to be
written.  The caller owns the socket, the threads and the locks; one
connection object is driven under one lock.

* Frames: the 9-byte header and every frame type, padding (DATA and
  HEADERS), the priority block of HEADERS (read and ignored), PRIORITY
  frames (ignored), unknown types (ignored).
* HEADERS: a block split over CONTINUATION frames is joined before it is
  decoded (``hpack.py``); no other frame may come between.  A stream's
  first block is its request (or response), a later one its trailers,
  which must end the stream.  Each block is decoded even on a stream that
  is gone, so the two HPACK tables stay in step.
* SETTINGS both ways, each acknowledged; a value of this side takes
  effect when the peer acknowledges it.  ``MAX_FRAME_SIZE`` bounds the
  frames each side sends, ``INITIAL_WINDOW_SIZE`` the streams' windows (a
  change moves the windows of the streams already open),
  ``MAX_CONCURRENT_STREAMS`` the streams the peer may open (one more is
  refused with REFUSED_STREAM) and ``HEADER_TABLE_SIZE`` the decoder's
  table.  PING is acknowledged.  PUSH_PROMISE is a PROTOCOL_ERROR: push is
  off (``ENABLE_PUSH`` 0) and a server never receives one.
* Flow control both ways: :meth:`send_data` never passes the smaller of
  the connection's and the stream's window (:meth:`local_flow_window`
  says how much may go); DATA received is held to the windows this side
  announced, and :meth:`acknowledge_received_data`, called as the
  application consumes data, sends WINDOW_UPDATE for the connection and
  the stream once half a window is owed.  Data of a stream that is reset
  or closed before it was consumed is given back to the connection's
  window at once, so the connection never starves.
* Errors: a connection error queues GOAWAY with its code and the last
  stream processed, then raises :class:`H2ProtocolError` (the caller
  writes what is queued and closes); a stream error queues RST_STREAM and
  returns a :class:`StreamReset` event with ``remote=False``.  The
  checks: stream ids (parity, order, frames on idle streams), frames on
  closed streams, frames over the maximum size, the fixed lengths of
  SETTINGS, PING, RST_STREAM, WINDOW_UPDATE, PRIORITY and GOAWAY, padding
  longer than its frame, window overflow, a zero WINDOW_UPDATE, settings
  out of range and malformed header blocks (COMPRESSION_ERROR).
"""

from __future__ import annotations

import struct
from collections import deque
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Dict, List, Optional, Sequence, Tuple

from .hpack import DEFAULT_TABLE_SIZE, Decoder, Encoder, HpackError

__all__ = ["PREFACE", "ErrorCode", "Setting", "H2Connection",
           "H2ProtocolError", "FlowControlBlocked", "HeadersReceived",
           "DataReceived", "StreamEnded", "StreamReset", "WindowUpdated",
           "RemoteSettingsChanged", "SettingsAcknowledged", "PingReceived",
           "PingAckReceived", "ConnectionTerminated"]

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

# frame types
DATA, HEADERS, PRIORITY, RST_STREAM, SETTINGS, PUSH_PROMISE, PING, \
    GOAWAY, WINDOW_UPDATE, CONTINUATION = range(10)
# flags
END_STREAM = 0x1
ACK = 0x1
END_HEADERS = 0x4
PADDED = 0x8
PRIORITY_FLAG = 0x20

MAX_WINDOW = 2 ** 31 - 1
DEFAULT_WINDOW = 65535
DEFAULT_MAX_FRAME = 16384
#: a header block joined from CONTINUATION frames may not pass this
MAX_HEADER_BLOCK = 1 << 20
#: the streams this side remembers having reset (frames on them ignored)
_RESET_MEMORY = 4096

_FRAME_HEADER = struct.Struct(">I B I")  # 24-bit length packed with type


class ErrorCode(IntEnum):
    NO_ERROR = 0x0
    PROTOCOL_ERROR = 0x1
    INTERNAL_ERROR = 0x2
    FLOW_CONTROL_ERROR = 0x3
    SETTINGS_TIMEOUT = 0x4
    STREAM_CLOSED = 0x5
    FRAME_SIZE_ERROR = 0x6
    REFUSED_STREAM = 0x7
    CANCEL = 0x8
    COMPRESSION_ERROR = 0x9
    CONNECT_ERROR = 0xA
    ENHANCE_YOUR_CALM = 0xB
    INADEQUATE_SECURITY = 0xC
    HTTP_1_1_REQUIRED = 0xD


class Setting(IntEnum):
    HEADER_TABLE_SIZE = 0x1
    ENABLE_PUSH = 0x2
    MAX_CONCURRENT_STREAMS = 0x3
    INITIAL_WINDOW_SIZE = 0x4
    MAX_FRAME_SIZE = 0x5
    MAX_HEADER_LIST_SIZE = 0x6


_DEFAULT_SETTINGS = {
    Setting.HEADER_TABLE_SIZE: DEFAULT_TABLE_SIZE,
    Setting.ENABLE_PUSH: 1,
    Setting.MAX_CONCURRENT_STREAMS: MAX_WINDOW,  # unlimited
    Setting.INITIAL_WINDOW_SIZE: DEFAULT_WINDOW,
    Setting.MAX_FRAME_SIZE: DEFAULT_MAX_FRAME,
    Setting.MAX_HEADER_LIST_SIZE: MAX_WINDOW,  # unlimited
}


class H2ProtocolError(Exception):
    """A connection error: GOAWAY with ``code`` is queued; the caller
    writes it and closes the connection."""

    def __init__(self, code: ErrorCode, message: str):
        super().__init__(f"{code.name}: {message}")
        self.code = code


class FlowControlBlocked(ValueError):
    """``send_data`` was asked for more than the window lets go (the
    caller's fault: it must wait for window)."""


# -- events -------------------------------------------------------------------
@dataclass
class HeadersReceived:
    """A header block: a stream's request or response, or its trailers."""
    stream_id: int
    headers: List[Tuple[str, str]]
    end_stream: bool
    trailers: bool = False


@dataclass
class DataReceived:
    """A DATA frame's payload; ``flow_controlled_length`` (padding
    included) is what to acknowledge once consumed."""
    stream_id: int
    data: bytes
    flow_controlled_length: int
    end_stream: bool


@dataclass
class StreamEnded:
    stream_id: int


@dataclass
class StreamReset:
    """A stream ended by RST_STREAM: the peer's (``remote``) or this
    side's answer to a stream error."""
    stream_id: int
    error_code: int
    remote: bool = True


@dataclass
class WindowUpdated:
    """More window to send on (``stream_id`` 0: the connection's; also
    sent when a settings change moved the streams' windows)."""
    stream_id: int
    delta: int


@dataclass
class RemoteSettingsChanged:
    changed: Dict[int, int] = field(default_factory=dict)


@dataclass
class SettingsAcknowledged:
    changed: Dict[int, int] = field(default_factory=dict)


@dataclass
class PingReceived:
    data: bytes


@dataclass
class PingAckReceived:
    data: bytes


@dataclass
class ConnectionTerminated:
    """GOAWAY from the peer: streams above ``last_stream_id`` were not
    processed."""
    error_code: int
    last_stream_id: int
    additional_data: bytes = b""


class _Stream:
    __slots__ = ("id", "send_window", "recv_window", "local_open",
                 "remote_open", "blocks", "unconsumed", "owed", "local")

    def __init__(self, sid: int, send_window: int, recv_window: int,
                 local: bool):
        self.id = sid
        self.send_window = send_window
        self.recv_window = recv_window
        self.local_open = True
        self.remote_open = True
        self.blocks = 0  # header blocks received
        self.unconsumed = 0  # flow-controlled bytes not yet acknowledged
        self.owed = 0  # acknowledged, not yet announced in WINDOW_UPDATE
        self.local = local  # opened by this side


def _frame(ftype: int, flags: int, sid: int, payload=b"") -> bytes:
    n = len(payload)
    return _FRAME_HEADER.pack((n << 8) | ftype, flags, sid) + bytes(payload)


class H2Connection:
    """One side of an HTTP/2 connection.

    ``client``: this side opens the streams (odd ids) and sends the
    preface.  ``settings``: the values this side announces, beyond the
    defaults (``ENABLE_PUSH`` is always 0).  ``connection_window``: the
    receive window of the whole connection, raised from 65,535 by a
    WINDOW_UPDATE at the start."""

    def __init__(self, client: bool, settings: Optional[Dict[int, int]]
                 = None, connection_window: int = DEFAULT_WINDOW):
        self.client = client
        self.local_settings: Dict[int, int] = dict(_DEFAULT_SETTINGS)
        self._announce = {Setting.ENABLE_PUSH: 0, **(settings or {})}
        self.local_settings.update(self._announce)
        # what the peer has acknowledged (what it holds this side to)
        self._acked: Dict[int, int] = dict(_DEFAULT_SETTINGS)
        self._pending_acks: deque = deque()
        self.peer_settings: Dict[int, int] = dict(_DEFAULT_SETTINGS)
        self._connection_window = connection_window
        self.send_window = DEFAULT_WINDOW  # the connection's, outbound
        self.recv_window = DEFAULT_WINDOW  # the connection's, inbound
        self._conn_owed = 0
        self.streams: Dict[int, _Stream] = {}
        self._reset: deque = deque(maxlen=_RESET_MEMORY)
        self._reset_set: set = set()
        self.highest_local = 0
        self.highest_remote = 0
        self.next_stream_id = 1 if client else 2
        self.encoder = Encoder()
        self.decoder = Decoder(self.local_settings[
            Setting.HEADER_TABLE_SIZE])
        self._out = bytearray()
        self._in = bytearray()
        self._preface_pending = not client  # a server reads it first
        self._settings_seen = False
        self._continuation: Optional[list] = None
        self.goaway_sent = False
        self.goaway_received: Optional[int] = None
        self.closed = False

    # -- output -----------------------------------------------------------
    def initiate(self) -> None:
        """The connection's first frames: the preface (a client's), this
        side's SETTINGS and the connection window's raise."""
        if self.client:
            self._out += PREFACE
        payload = b"".join(struct.pack(">HI", int(k), v)
                           for k, v in self._announce.items())
        self._pending_acks.append(dict(self._announce))
        self._out += _frame(SETTINGS, 0, 0, payload)
        raise_by = self._connection_window - DEFAULT_WINDOW
        if raise_by > 0:
            self.recv_window += raise_by
            self._out += _frame(WINDOW_UPDATE, 0, 0,
                                struct.pack(">I", raise_by))

    def data_to_send(self) -> bytearray:
        """The bytes queued so far (the caller writes them in order)."""
        out, self._out = self._out, bytearray()
        return out

    def has_data_to_send(self) -> bool:
        return bool(self._out)

    @property
    def max_outbound_frame_size(self) -> int:
        return self.peer_settings[Setting.MAX_FRAME_SIZE]

    def local_flow_window(self, sid: int) -> int:
        """The DATA bytes that may go on stream ``sid`` now."""
        s = self.streams.get(sid)
        if s is None or not s.local_open:
            return 0
        return max(0, min(self.send_window, s.send_window))

    def open_outbound_streams(self) -> int:
        return sum(1 for s in self.streams.values() if s.local)

    def can_open_stream(self) -> bool:
        """Whether the peer's MAX_CONCURRENT_STREAMS lets this side open
        one more stream (and no GOAWAY has come)."""
        return (self.goaway_received is None and not self.goaway_sent
                and self.open_outbound_streams()
                < self.peer_settings[Setting.MAX_CONCURRENT_STREAMS])

    def get_next_available_stream_id(self) -> int:
        return self.next_stream_id

    def send_headers(self, sid: int, headers: Sequence[Tuple[str, str]],
                     end_stream: bool = False) -> None:
        s = self.streams.get(sid)
        if s is None:
            if sid != self.next_stream_id or sid % 2 != (
                    1 if self.client else 0):
                raise ValueError(f"stream {sid} cannot be opened now")
            s = _Stream(sid, self.peer_settings[Setting.INITIAL_WINDOW_SIZE],
                        self._acked[Setting.INITIAL_WINDOW_SIZE], True)
            self.streams[sid] = s
            self.highest_local = sid
            self.next_stream_id += 2
        if not s.local_open:
            raise ValueError(f"stream {sid} is closed for sending")
        block = self.encoder.encode(headers)
        size = self.max_outbound_frame_size
        flags = END_STREAM if end_stream else 0
        first, rest = block[:size], block[size:]
        self._out += _frame(HEADERS, flags | (0 if rest else END_HEADERS),
                            sid, first)
        while rest:
            chunk, rest = rest[:size], rest[size:]
            self._out += _frame(CONTINUATION, 0 if rest else END_HEADERS,
                                sid, chunk)
        if end_stream:
            self._close_local(s)

    def send_data(self, sid: int, data, end_stream: bool = False) -> None:
        """Queue ``data`` on stream ``sid`` in frames of at most the
        peer's frame size; FlowControlBlocked where it passes the
        window."""
        s = self.streams.get(sid)
        if s is None or not s.local_open:
            raise ValueError(f"stream {sid} is closed for sending")
        n = len(data)
        if n == 0 and not end_stream:
            return
        if n > min(self.send_window, s.send_window):
            raise FlowControlBlocked(
                f"{n} bytes passes the window of stream {sid}")
        self.send_window -= n
        s.send_window -= n
        view = memoryview(data)
        size = self.max_outbound_frame_size
        pos = 0
        while True:
            chunk = view[pos:pos + size]
            pos += len(chunk)
            last = pos >= n
            self._out += _FRAME_HEADER.pack(
                (len(chunk) << 8) | DATA,
                END_STREAM if (last and end_stream) else 0, sid)
            self._out += chunk
            if last:
                break
        if end_stream:
            self._close_local(s)

    def end_stream(self, sid: int) -> None:
        self.send_data(sid, b"", end_stream=True)

    def reset_stream(self, sid: int,
                     code: ErrorCode = ErrorCode.CANCEL) -> None:
        s = self.streams.get(sid)
        if s is None:
            return
        self._out += _frame(RST_STREAM, 0, sid, struct.pack(">I", code))
        self._forget(s, reset=True)

    def ping(self, data: bytes = b"\0" * 8) -> None:
        self._out += _frame(PING, 0, 0, data)

    def close_connection(self, code: ErrorCode = ErrorCode.NO_ERROR,
                         last_stream_id: Optional[int] = None,
                         data: bytes = b"") -> None:
        """Queue GOAWAY: streams the peer opens after ``last_stream_id``
        (default: the last one it opened) are not processed."""
        last = self.highest_remote if last_stream_id is None \
            else last_stream_id
        self._out += _frame(GOAWAY, 0, 0,
                            struct.pack(">II", last, code) + data)
        self.goaway_sent = True
        self._goaway_last = last

    def update_settings(self, changes: Dict[int, int]) -> None:
        payload = b"".join(struct.pack(">HI", int(k), v)
                           for k, v in changes.items())
        self.local_settings.update(changes)
        self._pending_acks.append(dict(changes))
        self._out += _frame(SETTINGS, 0, 0, payload)

    def acknowledge_received_data(self, n: int, sid: int) -> None:
        """The application consumed ``n`` flow-controlled bytes of stream
        ``sid``: WINDOW_UPDATE once half a window is owed."""
        s = self.streams.get(sid)
        if s is None or n <= 0:
            return  # given back when the stream went away
        n = min(n, s.unconsumed)
        s.unconsumed -= n
        self._owe_connection(n)
        if s.remote_open:
            s.owed += n
            if s.owed >= max(1, self._acked[
                    Setting.INITIAL_WINDOW_SIZE] // 2):
                self._out += _frame(WINDOW_UPDATE, 0, sid,
                                    struct.pack(">I", s.owed))
                s.recv_window += s.owed
                s.owed = 0

    def _owe_connection(self, n: int) -> None:
        if n <= 0:
            return
        self._conn_owed += n
        if self._conn_owed >= max(1, self._connection_window // 2):
            self._out += _frame(WINDOW_UPDATE, 0, 0,
                                struct.pack(">I", self._conn_owed))
            self.recv_window += self._conn_owed
            self._conn_owed = 0

    # -- stream bookkeeping ------------------------------------------------
    def _close_local(self, s: _Stream) -> None:
        s.local_open = False
        if not s.remote_open:
            self._forget(s)

    def _close_remote(self, s: _Stream) -> None:
        s.remote_open = False
        if not s.local_open:
            self._forget(s)

    def _forget(self, s: _Stream, reset: bool = False) -> None:
        if self.streams.pop(s.id, None) is None:
            return
        # data never consumed goes back to the connection's window
        self._owe_connection(s.unconsumed)
        s.unconsumed = 0
        s.local_open = s.remote_open = False
        if reset:
            if len(self._reset) == self._reset.maxlen:
                self._reset_set.discard(self._reset[0])
            self._reset.append(s.id)
            self._reset_set.add(s.id)

    def _is_idle(self, sid: int) -> bool:
        """Never opened: above the highest id of its initiator."""
        local = (sid % 2 == 1) == self.client
        return sid > (self.highest_local if local else self.highest_remote)

    def _stream_error(self, sid: int, code: ErrorCode, events: list):
        self._out += _frame(RST_STREAM, 0, sid, struct.pack(">I", code))
        s = self.streams.get(sid)
        if s is not None:
            self._forget(s, reset=True)
        else:
            self._reset.append(sid)
            self._reset_set.add(sid)
        events.append(StreamReset(sid, code, remote=False))

    def _connection_error(self, code: ErrorCode, message: str):
        if not self.closed:
            self.close_connection(code)
            self.closed = True
        raise H2ProtocolError(code, message)

    # -- input ------------------------------------------------------------
    def receive_data(self, data) -> list:
        """The events of the bytes ``data``; H2ProtocolError on a
        connection error (GOAWAY queued)."""
        if self.closed:
            return []
        events: list = []
        if self._in:
            self._in += data
            buf = memoryview(self._in)
        else:
            buf = memoryview(data)
        pos = 0
        if self._preface_pending:
            if len(buf) < len(PREFACE):
                if bytes(buf) != PREFACE[:len(buf)]:
                    self._connection_error(ErrorCode.PROTOCOL_ERROR,
                                           "invalid connection preface")
                self._keep(buf, 0)
                return events
            if bytes(buf[:len(PREFACE)]) != PREFACE:
                self._connection_error(ErrorCode.PROTOCOL_ERROR,
                                       "invalid connection preface")
            self._preface_pending = False
            pos = len(PREFACE)
        limit = max(self._acked[Setting.MAX_FRAME_SIZE],
                    self.local_settings[Setting.MAX_FRAME_SIZE])
        while len(buf) - pos >= 9:
            word, flags, sid = _FRAME_HEADER.unpack_from(buf, pos)
            length, ftype = word >> 8, word & 0xFF
            sid &= 0x7FFFFFFF
            if length > limit:
                self._connection_error(
                    ErrorCode.FRAME_SIZE_ERROR,
                    f"frame of {length} bytes passes {limit}")
            if len(buf) - pos - 9 < length:
                break
            payload = buf[pos + 9:pos + 9 + length]
            pos += 9 + length
            self._frame_in(ftype, flags, sid, payload, events)
        self._keep(buf, pos)
        return events

    def _keep(self, buf: memoryview, pos: int) -> None:
        self._in = bytearray(buf[pos:]) if pos < len(buf) else bytearray()

    def _frame_in(self, ftype, flags, sid, payload, events) -> None:
        if not self._settings_seen:
            if ftype != SETTINGS or flags & ACK:
                self._connection_error(ErrorCode.PROTOCOL_ERROR,
                                       "the first frame is not SETTINGS")
            self._settings_seen = True
        if self._continuation is not None and ftype != CONTINUATION:
            self._connection_error(ErrorCode.PROTOCOL_ERROR,
                                   "a frame inside a header block")
        handler = _HANDLERS.get(ftype)
        if handler is not None:
            handler(self, flags, sid, payload, events)

    @staticmethod
    def _unpad(flags, payload, what: str, conn) -> memoryview:
        if not flags & PADDED:
            return payload
        if len(payload) < 1 or payload[0] >= len(payload):
            conn._connection_error(ErrorCode.PROTOCOL_ERROR,
                                   f"padding longer than its {what} frame")
        return payload[1:len(payload) - payload[0]]

    def _on_data(self, flags, sid, payload, events) -> None:
        if sid == 0:
            self._connection_error(ErrorCode.PROTOCOL_ERROR,
                                   "DATA on stream 0")
        n = len(payload)
        self.recv_window -= n
        if self.recv_window < 0:
            self._connection_error(ErrorCode.FLOW_CONTROL_ERROR,
                                   "DATA past the connection's window")
        s = self.streams.get(sid)
        if s is None or not s.remote_open:
            if s is None and self._is_idle(sid):
                self._connection_error(ErrorCode.PROTOCOL_ERROR,
                                       f"DATA on idle stream {sid}")
            self._owe_connection(n)  # nobody will consume it
            if sid not in self._reset_set:
                self._stream_error(sid, ErrorCode.STREAM_CLOSED, events)
            return
        data = self._unpad(flags, payload, "DATA", self)
        s.recv_window -= n
        if s.recv_window < 0:
            self._owe_connection(n)
            self._stream_error(sid, ErrorCode.FLOW_CONTROL_ERROR, events)
            return
        s.unconsumed += n
        end = bool(flags & END_STREAM)
        events.append(DataReceived(sid, bytes(data), n, end))
        if end:
            self._close_remote(s)
            events.append(StreamEnded(sid))

    def _on_headers(self, flags, sid, payload, events) -> None:
        if sid == 0:
            self._connection_error(ErrorCode.PROTOCOL_ERROR,
                                   "HEADERS on stream 0")
        block = self._unpad(flags, payload, "HEADERS", self)
        if flags & PRIORITY_FLAG:
            if len(block) < 5:
                self._connection_error(ErrorCode.FRAME_SIZE_ERROR,
                                       "HEADERS too short for priority")
            block = block[5:]
        self._continuation = [sid, flags, bytearray(block)]
        if flags & END_HEADERS:
            self._end_block(events)

    def _on_continuation(self, flags, sid, payload, events) -> None:
        cont = self._continuation
        if cont is None or cont[0] != sid:
            self._connection_error(ErrorCode.PROTOCOL_ERROR,
                                   "CONTINUATION outside a header block")
        cont[2] += payload
        if len(cont[2]) > MAX_HEADER_BLOCK:
            self._connection_error(ErrorCode.ENHANCE_YOUR_CALM,
                                   "header block too large")
        if flags & END_HEADERS:
            self._end_block(events)

    def _end_block(self, events) -> None:
        sid, flags, block = self._continuation
        self._continuation = None
        try:
            headers = self.decoder.decode(block)
        except HpackError as e:
            self._connection_error(ErrorCode.COMPRESSION_ERROR, str(e))
        end = bool(flags & END_STREAM)
        s = self.streams.get(sid)
        if s is None:
            if sid in self._reset_set:
                return  # a stream this side reset: decoded, dropped
            if not self._is_idle(sid):
                self._connection_error(ErrorCode.STREAM_CLOSED,
                                       f"HEADERS on closed stream {sid}")
            if self.client or sid % 2 == 0:
                self._connection_error(
                    ErrorCode.PROTOCOL_ERROR,
                    f"stream {sid} opened by the wrong side")
            self.highest_remote = sid
            if self.goaway_sent and sid > self._goaway_last:
                return  # after GOAWAY: not processed
            s = _Stream(sid, self.peer_settings[Setting.INITIAL_WINDOW_SIZE],
                        self._acked[Setting.INITIAL_WINDOW_SIZE], False)
            self.streams[sid] = s
            inbound = sum(1 for t in self.streams.values() if not t.local)
            if inbound > self._acked[Setting.MAX_CONCURRENT_STREAMS]:
                self._stream_error(sid, ErrorCode.REFUSED_STREAM, events)
                return
        elif not s.remote_open:
            self._stream_error(sid, ErrorCode.STREAM_CLOSED, events)
            return
        trailers = s.blocks > 0
        s.blocks += 1
        if (trailers and not end) or not _well_formed(headers):
            self._stream_error(sid, ErrorCode.PROTOCOL_ERROR, events)
            return
        events.append(HeadersReceived(sid, headers, end, trailers))
        if end:
            self._close_remote(s)
            events.append(StreamEnded(sid))

    def _on_priority(self, flags, sid, payload, events) -> None:
        if sid == 0:
            self._connection_error(ErrorCode.PROTOCOL_ERROR,
                                   "PRIORITY on stream 0")
        if len(payload) != 5:
            self._stream_error(sid, ErrorCode.FRAME_SIZE_ERROR, events)

    def _on_rst_stream(self, flags, sid, payload, events) -> None:
        if sid == 0:
            self._connection_error(ErrorCode.PROTOCOL_ERROR,
                                   "RST_STREAM on stream 0")
        if len(payload) != 4:
            self._connection_error(ErrorCode.FRAME_SIZE_ERROR,
                                   "RST_STREAM is not 4 bytes")
        s = self.streams.get(sid)
        if s is None:
            if self._is_idle(sid):
                self._connection_error(ErrorCode.PROTOCOL_ERROR,
                                       f"RST_STREAM on idle stream {sid}")
            return
        self._forget(s)
        events.append(StreamReset(sid, struct.unpack(">I", payload)[0],
                                  remote=True))

    def _on_settings(self, flags, sid, payload, events) -> None:
        if sid != 0:
            self._connection_error(ErrorCode.PROTOCOL_ERROR,
                                   "SETTINGS on a stream")
        if flags & ACK:
            if len(payload):
                self._connection_error(ErrorCode.FRAME_SIZE_ERROR,
                                       "SETTINGS ACK with a payload")
            if not self._pending_acks:
                return
            changed = self._pending_acks.popleft()
            old = self._acked[Setting.INITIAL_WINDOW_SIZE]
            self._acked.update(changed)
            delta = self._acked[Setting.INITIAL_WINDOW_SIZE] - old
            if delta:
                for s in self.streams.values():
                    s.recv_window += delta
            events.append(SettingsAcknowledged(changed))
            return
        if len(payload) % 6:
            self._connection_error(ErrorCode.FRAME_SIZE_ERROR,
                                   "SETTINGS length not a multiple of 6")
        changed: Dict[int, int] = {}
        for i in range(0, len(payload), 6):
            key, value = struct.unpack_from(">HI", payload, i)
            if key == Setting.ENABLE_PUSH and value not in (0, 1):
                self._connection_error(ErrorCode.PROTOCOL_ERROR,
                                       "ENABLE_PUSH not 0 or 1")
            if key == Setting.INITIAL_WINDOW_SIZE and value > MAX_WINDOW:
                self._connection_error(ErrorCode.FLOW_CONTROL_ERROR,
                                       "INITIAL_WINDOW_SIZE too large")
            if key == Setting.MAX_FRAME_SIZE and not (
                    DEFAULT_MAX_FRAME <= value <= 2 ** 24 - 1):
                self._connection_error(ErrorCode.PROTOCOL_ERROR,
                                       "MAX_FRAME_SIZE out of range")
            if key in _DEFAULT_SETTINGS:
                changed[key] = value
        old = self.peer_settings[Setting.INITIAL_WINDOW_SIZE]
        self.peer_settings.update(changed)
        delta = self.peer_settings[Setting.INITIAL_WINDOW_SIZE] - old
        if delta:
            for s in self.streams.values():
                s.send_window += delta
                if s.send_window > MAX_WINDOW:
                    self._connection_error(
                        ErrorCode.FLOW_CONTROL_ERROR,
                        "INITIAL_WINDOW_SIZE overflows a stream's window")
        self._out += _frame(SETTINGS, ACK, 0)
        events.append(RemoteSettingsChanged(changed))
        if delta > 0:
            events.append(WindowUpdated(0, 0))

    def _on_push_promise(self, flags, sid, payload, events) -> None:
        self._connection_error(ErrorCode.PROTOCOL_ERROR,
                               "PUSH_PROMISE: push is off")

    def _on_ping(self, flags, sid, payload, events) -> None:
        if sid != 0:
            self._connection_error(ErrorCode.PROTOCOL_ERROR,
                                   "PING on a stream")
        if len(payload) != 8:
            self._connection_error(ErrorCode.FRAME_SIZE_ERROR,
                                   "PING is not 8 bytes")
        data = bytes(payload)
        if flags & ACK:
            events.append(PingAckReceived(data))
        else:
            self._out += _frame(PING, ACK, 0, data)
            events.append(PingReceived(data))

    def _on_goaway(self, flags, sid, payload, events) -> None:
        if sid != 0:
            self._connection_error(ErrorCode.PROTOCOL_ERROR,
                                   "GOAWAY on a stream")
        if len(payload) < 8:
            self._connection_error(ErrorCode.FRAME_SIZE_ERROR,
                                   "GOAWAY shorter than 8 bytes")
        last, code = struct.unpack_from(">II", payload)
        last &= 0x7FFFFFFF
        self.goaway_received = last
        events.append(ConnectionTerminated(code, last, bytes(payload[8:])))

    def _on_window_update(self, flags, sid, payload, events) -> None:
        if len(payload) != 4:
            self._connection_error(ErrorCode.FRAME_SIZE_ERROR,
                                   "WINDOW_UPDATE is not 4 bytes")
        inc = struct.unpack(">I", payload)[0] & 0x7FFFFFFF
        if sid == 0:
            if inc == 0:
                self._connection_error(ErrorCode.PROTOCOL_ERROR,
                                       "WINDOW_UPDATE of 0")
            self.send_window += inc
            if self.send_window > MAX_WINDOW:
                self._connection_error(ErrorCode.FLOW_CONTROL_ERROR,
                                       "the connection's window overflows")
            events.append(WindowUpdated(0, inc))
            return
        s = self.streams.get(sid)
        if s is None:
            if self._is_idle(sid):
                self._connection_error(
                    ErrorCode.PROTOCOL_ERROR,
                    f"WINDOW_UPDATE on idle stream {sid}")
            return
        if inc == 0:
            self._stream_error(sid, ErrorCode.PROTOCOL_ERROR, events)
            return
        s.send_window += inc
        if s.send_window > MAX_WINDOW:
            self._stream_error(sid, ErrorCode.FLOW_CONTROL_ERROR, events)
            return
        events.append(WindowUpdated(sid, inc))


_HANDLERS = {
    DATA: H2Connection._on_data,
    HEADERS: H2Connection._on_headers,
    PRIORITY: H2Connection._on_priority,
    RST_STREAM: H2Connection._on_rst_stream,
    SETTINGS: H2Connection._on_settings,
    PUSH_PROMISE: H2Connection._on_push_promise,
    PING: H2Connection._on_ping,
    GOAWAY: H2Connection._on_goaway,
    WINDOW_UPDATE: H2Connection._on_window_update,
    CONTINUATION: H2Connection._on_continuation,
}

#: headers an HTTP/2 message may not carry (RFC 9113 8.2.2)
_CONNECTION_SPECIFIC = frozenset(("connection", "keep-alive",
                                  "proxy-connection", "transfer-encoding",
                                  "upgrade"))


def _well_formed(headers: List[Tuple[str, str]]) -> bool:
    """Lower-case names, pseudo-headers first, no connection-specific
    field, ``te`` only ``trailers``."""
    regular = False
    for name, value in headers:
        if name != name.lower() or not name:
            return False
        if name[0] == ":":
            if regular:
                return False
        else:
            regular = True
            if name in _CONNECTION_SPECIFIC or (name == "te"
                                                and value != "trailers"):
                return False
    return True
