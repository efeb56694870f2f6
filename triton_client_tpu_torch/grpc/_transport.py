"""gRPC-Web on the client: the port's gRPC calls over HTTP/1.1, where the
peer does not speak HTTP/2 (``_h2_transport.select_transport``).

The port's server speaks gRPC as gRPC-Web on its HTTP port
(``server/grpc_web.py``), and so does the reference's bridge.  Frames are
``<1 byte flags><4 bytes big-endian length><message>``; an answer ends with
a trailers frame (flags 0x80) holding ``grpc-status`` and a percent-encoded
``grpc-message``.

* Unary calls go on the HTTP client's pool of kept-alive ``http.client``
  connections (``http/_client.py``, ``_ConnectionPool``), with its re-send
  rule: a request is sent again only where it failed on a reused
  connection before any response byte arrived.  The status comes from the
  trailers frame, or from the ``grpc-status`` header of a trailers-only
  answer.
* A stream needs a socket of its own: ``http.client`` cannot read a
  response before the request body has ended.  :class:`StreamCall` writes
  the request head with ``Transfer-Encoding: chunked`` and then one chunk
  per request frame as each is sent; a reader thread parses the chunked
  response into frames as they arrive.  ``close_send`` sends the last
  chunk, after which the server ends the response with its trailers, as the
  reference's native client does (``native/client/grpc_client.cc``).
  With an ``ssl_context`` its socket is TLS, as the pool's connections are.
"""

from __future__ import annotations

import http.client
import socket
import threading
import time
import urllib.parse
from typing import Callable, Dict, Optional

from ..protocol.grpc_web import (CONTENT_TYPE, TRAILER_FLAG, iter_frames,
                                 parse_trailer_fields, parse_trailers,
                                 read_chunked)
from ..protocol.service import StatusCode, path

__all__ = ["RpcError", "StreamCall", "WebTransport", "unary",
           "unary_answer"]


class RpcError(Exception):
    """A call's non-OK status: ``code()`` and ``details()`` as
    ``grpc.RpcError`` has them."""

    def __init__(self, code: StatusCode, details: str,
                 trailing: Optional[Dict[str, str]] = None):
        super().__init__(details)
        self._code = code
        self._details = details
        self._trailing = trailing or {}

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details

    def trailing_metadata(self):
        """The answer's trailing metadata as ``(key, value)`` pairs (such as
        the server's ``retry-after-ms``)."""
        return tuple(self._trailing.items())


#: the status of an answer that is not gRPC-Web, by its HTTP status (gRPC's
#: HTTP-to-status mapping)
_HTTP_TO_STATUS = {400: StatusCode.INTERNAL,
                   401: StatusCode.UNAUTHENTICATED,
                   403: StatusCode.PERMISSION_DENIED,
                   404: StatusCode.UNIMPLEMENTED,
                   429: StatusCode.UNAVAILABLE, 502: StatusCode.UNAVAILABLE,
                   503: StatusCode.UNAVAILABLE, 504: StatusCode.UNAVAILABLE}


def http_error(status: int, body: bytes) -> RpcError:
    text = bytes(body[:512]).decode("utf-8", errors="replace")
    return RpcError(_HTTP_TO_STATUS.get(status, StatusCode.UNKNOWN),
                    f"HTTP {status}: {text}")


def unary(pool, method: str, frame: bytes, response_type, headers: dict,
          timeout: Optional[float] = None, sizes: Optional[list] = None):
    """One unary call of an encoded request ``frame`` on ``pool`` (an
    ``http._client._ConnectionPool``): the decoded response, or
    :class:`RpcError`.  ``sizes``, where given, gets the response
    message's encoded length appended."""
    hdrs = dict(headers)
    hdrs["Content-Type"] = CONTENT_TYPE
    try:
        resp = pool.request("POST", path(method), frame, hdrs,
                            timeout=timeout)
    except socket.timeout:
        raise RpcError(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded")
    except (OSError, http.client.HTTPException) as e:
        # refused, reset, or cut short inside the answer
        raise RpcError(StatusCode.UNAVAILABLE, f"failed to connect: {e}")
    return unary_answer(resp.status, resp.headers, resp.data, response_type,
                        sizes)


def unary_answer(http_status: int, headers, data: bytes, response_type,
                 sizes: Optional[list] = None):
    """The decoded message of a unary call's HTTP answer, or
    :class:`RpcError` with its status (the aio client's too)."""
    if http_status != 200:
        raise http_error(http_status, data)
    try:
        frames = list(iter_frames([data]))
    except ValueError as e:
        raise RpcError(StatusCode.INTERNAL, str(e))
    trailer = [p for flags, p in frames if flags & TRAILER_FLAG]
    frames = [p for flags, p in frames if not flags & TRAILER_FLAG]
    trailing: Dict[str, str] = {}
    if trailer:
        status, message, trailing = parse_trailer_fields(trailer[-1])
    else:  # trailers-only: the status is a header
        raw = headers.get("grpc-status")
        status = StatusCode.of(int(raw)) if raw is not None \
            else StatusCode.UNKNOWN
        message = urllib.parse.unquote(headers.get("grpc-message", ""))
    if status != StatusCode.OK:
        raise RpcError(status, message, trailing)
    if not frames:
        raise RpcError(StatusCode.INTERNAL, "missing response message")
    if sizes is not None:
        sizes.append(len(frames[0]))
    return response_type.FromString(frames[0])


class WebTransport:
    """The client's calls as gRPC-Web: unary on ``pool`` (an
    ``http._client._ConnectionPool``), each stream on a socket of its
    own.  ``_h2_transport.H2Transport`` has the same interface."""

    name = "web"

    def __init__(self, url: str, pool, ssl_context=None):
        self._url = url
        self.pool = pool
        self._ssl = ssl_context

    def unary(self, method: str, frame: bytes, response_type,
              headers: dict, timeout: Optional[float] = None,
              sizes: Optional[list] = None):
        return unary(self.pool, method, frame, response_type, headers,
                     timeout, sizes)

    def open_stream(self, method: str, headers: dict, on_message, on_end,
                    deadline_s: Optional[float] = None) -> "StreamCall":
        return StreamCall(self._url, method, headers, on_message, on_end,
                          deadline_s=deadline_s, ssl_context=self._ssl)

    def close(self) -> None:
        self.pool.clear()


class StreamCall:
    """One duplex gRPC-Web stream on a socket of its own.

    ``on_message(payload)`` runs on the reader thread for each response
    frame; ``on_end(code, message)`` once, when the response ended (its
    trailers' status), the connection broke (UNAVAILABLE), the call was
    cancelled (CANCELLED) or its ``deadline_s`` passed (DEADLINE_EXCEEDED:
    each read of the stream's socket waits at most until then)."""

    def __init__(self, host: str, method: str, headers: dict,
                 on_message: Callable[[bytes], None],
                 on_end: Callable[[StatusCode, str], None],
                 connect_timeout: float = 60.0,
                 deadline_s: Optional[float] = None, ssl_context=None):
        hostname, _, port = host.rpartition(":")
        if not hostname:
            hostname, port = host, "80"
        self._on_message, self._on_end = on_message, on_end
        self._cancelled = False
        self._deadline = (time.monotonic() + deadline_s
                          if deadline_s is not None else None)
        self._send_lock = threading.Lock()
        try:
            self._sock = socket.create_connection((hostname, int(port)),
                                                  timeout=connect_timeout)
            if ssl_context is not None:
                self._sock = ssl_context.wrap_socket(
                    self._sock, server_hostname=hostname)
        except OSError as e:
            raise RpcError(StatusCode.UNAVAILABLE, f"failed to connect: {e}")
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        head = [f"POST {path(method)} HTTP/1.1", f"Host: {host}",
                f"Content-Type: {CONTENT_TYPE}", "Transfer-Encoding: chunked"]
        head += [f"{k}: {v}" for k, v in headers.items()]
        self._sendall(("\r\n".join(head) + "\r\n\r\n").encode("latin-1"))
        self._reader = threading.Thread(target=self._read, daemon=True,
                                        name="tc-torch-grpc-stream")
        self._reader.start()

    def _sendall(self, data: bytes) -> None:
        with self._send_lock:
            self._sock.sendall(data)

    def send(self, frame: bytes) -> None:
        """Send one request frame as one chunk."""
        try:
            # tpu-lint: disable=WIRE-COPY a chunk's size line and its frame in one write
            self._sendall(b"%X\r\n%s\r\n" % (len(frame), frame))
        except OSError as e:
            raise RpcError(StatusCode.UNAVAILABLE,
                           f"the stream's connection broke: {e}")

    def close_send(self) -> None:
        """End the request body (the last chunk)."""
        try:
            self._sendall(b"0\r\n\r\n")
        except OSError:
            pass  # the reader reports the broken connection

    def cancel(self) -> None:
        self._cancelled = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    def join(self, timeout: Optional[float] = None) -> bool:
        self._reader.join(timeout)
        return not self._reader.is_alive()

    def close(self) -> None:
        self._sock.close()

    def _read(self) -> None:
        code, message = StatusCode.OK, ""
        try:
            rfile = self._sock.makefile("rb")
            if self._deadline is not None:
                rfile = _DeadlineReader(rfile, self._sock, self._deadline)
            status_line = rfile.readline(65537).decode("latin-1")
            parts = status_line.split(" ", 2)
            if len(parts) < 2 or not parts[0].startswith("HTTP/"):
                raise ConnectionError("no HTTP response on the stream")
            http_status = int(parts[1])
            headers = {}
            while True:
                line = rfile.readline(65537)
                if line in (b"\r\n", b"\n", b""):
                    break
                key, _, value = line.decode("latin-1").partition(":")
                headers[key.strip().lower()] = value.strip()
            if http_status != 200:
                n = int(headers.get("content-length", 0) or 0)
                err = http_error(http_status, rfile.read(n) if n else b"")
                code, message = err.code(), err.details()
                return
            code, message = StatusCode.UNKNOWN, "stream ended without status"
            if "grpc-status" in headers:
                code = StatusCode.of(int(headers["grpc-status"]))
                message = urllib.parse.unquote(
                    headers.get("grpc-message", ""))
            for flags, payload in iter_frames(read_chunked(rfile)):
                if flags & TRAILER_FLAG:
                    code, message = parse_trailers(payload)
                else:
                    self._on_message(payload)
        except socket.timeout:
            code, message = StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded"
        except (OSError, ValueError) as e:
            if self._cancelled:
                code, message = StatusCode.CANCELLED, \
                    "Locally cancelled by application!"
            else:
                code, message = StatusCode.UNAVAILABLE, \
                    f"the stream's connection broke: {e}"
        finally:
            if self._cancelled and code == StatusCode.OK:
                code, message = StatusCode.CANCELLED, \
                    "Locally cancelled by application!"
            self._on_end(code, message)


class _DeadlineReader:
    """A stream's reader under a deadline: before each read the socket's
    timeout is set to what is left, so the read that would outlast the
    deadline raises ``socket.timeout``."""

    def __init__(self, rfile, sock, deadline: float):
        self._rfile, self._sock, self._deadline = rfile, sock, deadline

    def _arm(self) -> None:
        left = self._deadline - time.monotonic()
        if left <= 0:
            raise socket.timeout("deadline exceeded")
        self._sock.settimeout(left)

    def read(self, *args):
        self._arm()
        return self._rfile.read(*args)

    def readline(self, *args):
        self._arm()
        return self._rfile.readline(*args)
