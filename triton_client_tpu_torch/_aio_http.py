"""HTTP/1.1 on ``asyncio`` streams: the one transport of the port's aio
clients (``http.aio`` and ``grpc.aio``).

The reference's aio clients sit on aiohttp and grpc.aio; the machine the
port serves on has neither, so this module speaks HTTP/1.1 itself over
``asyncio.open_connection`` (TLS with an ``ssl.SSLContext``).

* :class:`AioConnectionPool` holds at most ``limit`` connections to one
  server, kept alive between requests.  A request is sent again on another
  connection only where it failed on a reused connection before any byte
  of a response arrived (the sync pool's rule, ``http/_client.py``): the
  server closed that kept-alive connection while it sat idle.
* A response body is read by its ``Content-Length``, in chunked transfer
  coding, or to the end of the connection; it is returned as received
  (the caller undoes any ``Content-Encoding``, :func:`decompress`, as the
  reference's ``auto_decompress=False`` session does).
* ``timeout`` is the total of one request, connection included, as
  ``aiohttp.ClientTimeout(total=...)`` is: its expiry raises
  ``TimeoutError``.
* A request that is cancelled or times out closes its connection: a
  half-read connection never goes back to the pool.
* :meth:`AioConnectionPool.open_stream` opens a duplex exchange on a
  connection of its own (a gRPC-Web stream): the request body goes out in
  chunks as the caller writes them while the response is read.
"""

from __future__ import annotations

import asyncio
import gzip
import http.client
import io
import zlib
from collections import deque
from typing import AsyncIterator, Deque, Dict, Optional, Tuple

__all__ = ["AioConnectionPool", "AioResponse", "AioStream", "decompress"]

#: the longest status or header line taken
_MAX_LINE = 65536


class AioResponse:
    """One response read whole: status, headers (case-insensitive
    ``get``) and body."""

    __slots__ = ("status", "headers", "data")

    def __init__(self, status: int, headers: http.client.HTTPMessage,
                 data: bytes):
        self.status = status
        self.headers = headers
        self.data = data


class _NoResponse(Exception):
    """The connection ended before any byte of a response arrived."""


def decompress(headers, body: bytes) -> bytes:
    """``body`` with its ``Content-Encoding`` (gzip or deflate) undone."""
    encoding = headers.get("Content-Encoding", "")
    if encoding == "gzip":
        return gzip.decompress(body)
    if encoding == "deflate":
        return zlib.decompress(body)
    return body


async def _readline(reader: asyncio.StreamReader) -> bytes:
    line = await reader.readline()
    if len(line) > _MAX_LINE:
        raise http.client.LineTooLong("header line")
    return line


async def read_head(reader: asyncio.StreamReader
                    ) -> Tuple[int, http.client.HTTPMessage]:
    """A response's status and headers (interim 1xx responses skipped).
    Raises :class:`_NoResponse` where the connection ended before any
    byte."""
    while True:
        try:
            line = await _readline(reader)
        except ConnectionError:
            raise _NoResponse()
        if not line:
            raise _NoResponse()
        parts = line.decode("latin-1").split(None, 2)
        if len(parts) < 2 or not parts[0].startswith("HTTP/"):
            raise http.client.BadStatusLine(line.decode("latin-1",
                                                        "replace"))
        status = int(parts[1])
        lines = []
        while True:
            h = await _readline(reader)
            if h in (b"\r\n", b"\n", b""):
                break
            lines.append(h)
        if 100 <= status < 200:
            continue
        return status, http.client.parse_headers(io.BytesIO(b"".join(lines)))


async def iter_chunks(reader: asyncio.StreamReader) -> AsyncIterator[bytes]:
    """The chunks of a chunked body as they arrive (extensions and trailer
    fields ignored); a body cut short raises ``IncompleteRead``."""
    try:
        while True:
            line = await _readline(reader)
            if not line.endswith(b"\n"):
                raise http.client.IncompleteRead(b"")
            size = int(line.split(b";", 1)[0].strip(), 16)
            if size == 0:
                while (await _readline(reader)) not in (b"\r\n", b"\n", b""):
                    pass
                return
            data = await reader.readexactly(size)
            await reader.readexactly(2)
            yield data
    except asyncio.IncompleteReadError as e:
        raise http.client.IncompleteRead(e.partial)


async def read_body(reader: asyncio.StreamReader, method: str, status: int,
                    headers) -> Tuple[bytes, bool]:
    """(body, whether the connection may serve another request)."""
    keep = "close" not in headers.get("Connection", "").lower()
    if method == "HEAD" or status in (204, 304):
        return b"", keep
    if "chunked" in headers.get("Transfer-Encoding", "").lower():
        return b"".join([c async for c in iter_chunks(reader)]), keep
    length = headers.get("Content-Length")
    if length is None:
        return await reader.read(), False
    try:
        return await reader.readexactly(int(length)), keep
    except asyncio.IncompleteReadError as e:
        raise http.client.IncompleteRead(e.partial, int(length))


class _Connection:
    __slots__ = ("reader", "writer")

    def __init__(self, reader, writer):
        self.reader, self.writer = reader, writer

    def close(self) -> None:
        self.writer.close()


def _head(method: str, target: str, host: str, headers: Dict[str, str],
          extra: str) -> bytes:
    lines = [f"{method} {target} HTTP/1.1", f"Host: {host}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n" + extra + "\r\n").encode("latin-1")


class AioStream:
    """A duplex exchange on a connection of its own: ``write`` sends one
    chunk of the request body, ``end`` the last; ``read_head`` and
    ``chunks`` read the response as it arrives; ``close`` drops the
    connection."""

    def __init__(self, conn: _Connection):
        self._conn = conn

    async def write(self, data: bytes) -> None:
        w = self._conn.writer
        w.write(b"%X\r\n" % len(data))
        w.write(data)
        w.write(b"\r\n")
        await w.drain()

    async def end(self) -> None:
        self._conn.writer.write(b"0\r\n\r\n")
        await self._conn.writer.drain()

    async def read_head(self):
        try:
            return await read_head(self._conn.reader)
        except _NoResponse:
            raise ConnectionResetError(
                "the stream's connection closed without a response")

    def chunks(self) -> AsyncIterator[bytes]:
        return iter_chunks(self._conn.reader)

    async def read_to_end(self, headers) -> bytes:
        data, _ = await read_body(self._conn.reader, "POST", 0, headers)
        return data

    def close(self) -> None:
        self._conn.close()


class AioConnectionPool:
    """Kept-alive HTTP/1.1 connections to ``url`` (``host:port``) in one
    event loop, at most ``limit`` of them."""

    def __init__(self, url: str, limit: int = 100, ssl_context=None):
        self._url = url
        host, _, port = url.rpartition(":")
        if not host:
            host, port = url, "443" if ssl_context is not None else "80"
        self._host, self._port = host.strip("[]"), int(port)
        self._limit = max(1, int(limit or 1))
        self._ssl = ssl_context
        self._idle: Deque[_Connection] = deque()
        # made in the loop of the first request, which the connections
        # belong to
        self._sem: Optional[asyncio.Semaphore] = None
        self._closed = False
        #: requests sent again because a kept-alive connection was stale
        self.resends = 0

    def _slots(self) -> asyncio.Semaphore:
        if self._sem is None:
            self._sem = asyncio.Semaphore(self._limit)
        return self._sem

    async def _connect(self) -> _Connection:
        reader, writer = await asyncio.open_connection(
            self._host, self._port, ssl=self._ssl,
            server_hostname=self._host if self._ssl is not None else None,
            limit=1 << 20)
        return _Connection(reader, writer)

    async def request(self, method: str, target: str, headers: Dict[str, str],
                      body: Optional[bytes] = None,
                      timeout: Optional[float] = None) -> AioResponse:
        """One request, its response read whole; ``timeout`` is its total
        (TimeoutError past it)."""
        if timeout is None:
            return await self._request(method, target, headers, body)
        async with asyncio.timeout(timeout):
            return await self._request(method, target, headers, body)

    async def _request(self, method, target, headers, body) -> AioResponse:
        if self._closed:
            raise RuntimeError("the connection pool is closed")
        payload = body or b""
        head = _head(method, target, self._url, headers,
                     f"Content-Length: {len(payload)}\r\n"
                     if body is not None or method == "POST" else "")
        async with self._slots():
            while True:
                reused = bool(self._idle)
                conn = self._idle.pop() if reused else await self._connect()
                try:
                    try:
                        conn.writer.write(head)
                        if payload:
                            conn.writer.write(payload)
                        await conn.writer.drain()
                    except ConnectionError:
                        raise _NoResponse()
                    status, hdrs = await read_head(conn.reader)
                    data, keep = await read_body(conn.reader, method, status,
                                                 hdrs)
                except _NoResponse:
                    conn.close()
                    if reused:
                        self.resends += 1
                        continue
                    raise http.client.RemoteDisconnected(
                        "Remote end closed connection without response")
                except BaseException:
                    # cancelled, timed out or broken: never pooled again
                    conn.close()
                    raise
                if keep and not self._closed \
                        and len(self._idle) < self._limit:
                    self._idle.append(conn)
                else:
                    conn.close()
                return AioResponse(status, hdrs, data)

    async def open_stream(self, method: str, target: str,
                          headers: Dict[str, str]) -> AioStream:
        """A chunked request on a new connection of its own, its head sent;
        the caller writes the body and reads the response."""
        conn = await self._connect()
        try:
            conn.writer.write(_head(method, target, self._url, headers,
                                    "Transfer-Encoding: chunked\r\n"))
            await conn.writer.drain()
        except BaseException:
            conn.close()
            raise
        return AioStream(conn)

    async def close(self) -> None:
        """Close every idle connection; later requests raise."""
        self._closed = True
        idle, self._idle = list(self._idle), deque()
        for conn in idle:
            conn.close()
        for conn in idle:
            try:
                await conn.writer.wait_closed()
            except OSError:
                pass
