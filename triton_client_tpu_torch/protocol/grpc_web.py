"""gRPC-Web framing, shared by the port's server bridge
(``server/grpc_web.py``) and its client (``grpc/_transport.py``).

A body is a run of frames ``<1 byte flags><4 bytes big-endian
length><payload>``: data frames hold one encoded message each, and the
answer ends with a trailers frame (flags 0x80) whose payload is HTTP
header lines, ``grpc-status`` and a percent-encoded ``grpc-message``.  A
stream's bodies travel in chunked transfer coding, read here chunk by
chunk as they arrive.

A request frame may be compressed: flag bit 0x01 set, its payload in the
call's ``grpc-encoding`` (``gzip``, or ``deflate`` in zlib's wrapping, as
gRPC's deflate is).  Answers go back uncompressed.
"""

from __future__ import annotations

import gzip
import struct
import urllib.parse
import zlib
from typing import (AsyncIterator, Dict, Iterable, Iterator, Optional,
                    Tuple)

from .service import StatusCode

CONTENT_TYPE = "application/grpc-web+proto"
#: the request content types a server takes (others are a 415)
CONTENT_TYPES = (CONTENT_TYPE, "application/grpc-web", "application/grpc")
TRAILER_FLAG = 0x80
COMPRESSED_FLAG = 0x01
#: the request encodings a call may name in ``grpc-encoding``
ENCODINGS = ("gzip", "deflate")


def frame_header(length: int, flags: int = 0) -> bytes:
    return struct.pack(">BI", flags, length)


def encode_frame(message) -> bytes:
    """One data frame of ``message``: the header and the encoded message,
    gathered with one copy."""
    parts, n = message.encode_parts()
    # tpu-lint: disable=WIRE-COPY the one gather of the frame
    return b"".join([frame_header(n), *parts])


def compress_frame(frame: bytes, encoding: str) -> bytes:
    """A data frame (``encode_frame``'s) with its payload compressed in
    ``encoding`` and flag bit 0x01 set."""
    payload = memoryview(frame)[5:]
    data = (gzip.compress(payload) if encoding == "gzip"
            else zlib.compress(payload))
    return frame_header(len(data), COMPRESSED_FLAG) + data


def inflate(payload, encoding: str, cap: int = 0) -> bytes:
    """A compressed frame's message.  Where ``cap`` is set, inflation
    stops past it: the result is then ``cap + 1`` bytes long, and the
    caller refuses it as a message over the cap.  ValueError where the
    payload is corrupt or cut short."""
    wbits = 16 + zlib.MAX_WBITS if encoding == "gzip" else zlib.MAX_WBITS
    d = zlib.decompressobj(wbits)
    try:
        out = d.decompress(payload, cap + 1) if cap else \
            d.decompress(payload)
    except zlib.error as e:
        raise ValueError(f"corrupt {encoding} message: {e}")
    if not (cap and len(out) > cap) and not d.eof:
        raise ValueError(f"truncated {encoding} message")
    return out


def percent_encode(msg: str) -> str:
    """``grpc-message`` is percent-encoded (gRPC's HTTP/2 spec)."""
    out = []
    for b in msg.encode("utf-8"):
        if b == 0x25 or b < 0x20 or b > 0x7E:
            out.append(f"%{b:02X}")
        else:
            out.append(chr(b))
    return "".join(out)


def trailers(status: int, message: str = "",
             metadata: Optional[Dict[str, str]] = None) -> bytes:
    """The trailers frame of an answer, with any trailing ``metadata``
    (such as ``retry-after-ms``)."""
    text = f"grpc-status:{int(status)}\r\n"
    if message:
        text += f"grpc-message:{percent_encode(message)}\r\n"
    for key, value in (metadata or {}).items():
        text += f"{key}:{value}\r\n"
    payload = text.encode("ascii")
    return frame_header(len(payload), TRAILER_FLAG) + payload


def parse_trailers(payload) -> Tuple[StatusCode, str]:
    """(status, message) of a trailers frame; UNKNOWN without a status."""
    status, message, _ = parse_trailer_fields(payload)
    return status, message


def parse_trailer_fields(payload
                         ) -> Tuple[StatusCode, str, Dict[str, str]]:
    """(status, message, the other trailing metadata by lower-case name)
    of a trailers frame."""
    status, message = StatusCode.UNKNOWN, "missing grpc-status"
    metadata: Dict[str, str] = {}
    for line in bytes(payload).decode("utf-8", errors="replace").split(
            "\r\n"):
        key, sep, value = line.partition(":")
        key = key.strip().lower()
        if key == "grpc-status":
            status, message = StatusCode.of(int(value.strip())), ""
        elif key == "grpc-message":
            message = urllib.parse.unquote(value.strip())
        elif key and sep:
            metadata[key] = value.strip()
    return status, message, metadata


def read_chunked(rfile) -> Iterator[bytes]:
    """The chunks of a chunked body on a buffered reader, each as soon as
    it is in (extensions and trailer fields ignored).  A body cut short
    raises ConnectionError."""
    while True:
        line = rfile.readline(65537)
        if not line.endswith(b"\n"):
            raise ConnectionError("chunked body cut short")
        size = int(line.split(b";", 1)[0].strip(), 16)
        if size == 0:
            while rfile.readline(65537) not in (b"\r\n", b"\n", b""):
                pass  # trailer fields
            return
        data = rfile.read(size)
        if len(data) != size or rfile.readline(3) not in (b"\r\n", b"\n"):
            raise ConnectionError("chunked body cut short")
        yield data


def iter_frames(chunks: Iterable[bytes]) -> Iterator[Tuple[int, memoryview]]:
    """(flags, payload) of each frame of a body that arrives in
    ``chunks``, as soon as its last byte is in (:func:`iter_messages`
    without a cap).  A chunk of whole frames is sliced, not copied.  A
    body that ends inside a frame raises ValueError."""
    for flags, payload, _ in iter_messages(chunks):
        yield flags, payload


def _inflation_bound(cap: int) -> int:
    """The largest compressed payload that may still inflate to at most
    ``cap`` bytes (deflate's stored blocks grow the data by less than
    this)."""
    return cap + (cap >> 10) + 1024


def iter_messages(chunks: Iterable[bytes], cap: int = 0
                  ) -> Iterator[Tuple[int, Optional[memoryview], int]]:
    """(flags, payload, size) of each frame of a body that arrives in
    ``chunks``, as :func:`iter_frames` gives them, except that a frame
    whose 5-byte prefix already shows it over ``cap`` (a compressed one:
    too large to inflate within it) is not buffered: its payload is None
    as soon as the prefix is in, and its bytes are dropped as they
    arrive.  Its size is the prefix's, or ``cap + 1`` for a compressed
    frame (what inflating it under the cap reads)."""
    skip = 0
    # bytes of a frame not yet whole, and how many it needs to be
    pending = bytearray()
    need = 5
    for chunk in chunks:
        mv = memoryview(chunk)
        if skip:
            n = min(skip, len(mv))
            skip -= n
            mv = mv[n:]
        if not mv:
            continue
        if pending:
            pending += mv
            if len(pending) < need:
                continue
            # parsed in place: the yielded payloads are views of it, and
            # it is never written again
            mv, pending = memoryview(pending), bytearray()
        pos = 0
        need = 5
        while len(mv) - pos >= 5:
            flags, n = struct.unpack_from(">BI", mv, pos)
            compressed = flags & COMPRESSED_FLAG
            if cap and n > (_inflation_bound(cap) if compressed else cap):
                yield flags, None, (cap + 1 if compressed else n)
                have = min(n, len(mv) - pos - 5)
                skip = n - have
                pos += 5 + have
                continue
            if len(mv) - pos - 5 < n:
                need = 5 + n
                break
            yield flags, mv[pos + 5:pos + 5 + n], n
            pos += 5 + n
        pending += mv[pos:]
    if pending or skip:
        raise ValueError("truncated grpc-web frame")


async def aiter_frames(chunks: AsyncIterator[bytes]
                       ) -> AsyncIterator[Tuple[int, bytes]]:
    """:func:`iter_frames` over a body that arrives as an async iterator of
    chunks (the aio client's stream)."""
    buf = bytearray()
    async for chunk in chunks:
        buf += chunk
        while len(buf) >= 5:
            flags, n = struct.unpack_from(">BI", buf, 0)
            if len(buf) < 5 + n:
                break
            payload = bytes(buf[5:5 + n])
            del buf[:5 + n]
            yield flags, payload
    if buf:
        raise ValueError("truncated grpc-web frame")
