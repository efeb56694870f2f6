"""gRPC-Web framing, shared by the port's server bridge
(``server/grpc_web.py``) and its client (``grpc/_transport.py``).

A body is a run of frames ``<1 byte flags><4 bytes big-endian
length><payload>``: data frames hold one encoded message each, and the
answer ends with a trailers frame (flags 0x80) whose payload is HTTP
header lines, ``grpc-status`` and a percent-encoded ``grpc-message``.  A
stream's bodies travel in chunked transfer coding, read here chunk by
chunk as they arrive.
"""

from __future__ import annotations

import struct
import urllib.parse
from typing import Dict, Iterable, Iterator, Optional, Tuple

from .service import StatusCode

CONTENT_TYPE = "application/grpc-web+proto"
#: the request content types a server takes (others are a 415)
CONTENT_TYPES = (CONTENT_TYPE, "application/grpc-web", "application/grpc")
TRAILER_FLAG = 0x80


def frame_header(length: int, flags: int = 0) -> bytes:
    return struct.pack(">BI", flags, length)


def encode_frame(message) -> bytes:
    """One data frame of ``message``: the header and the encoded message,
    gathered with one copy."""
    parts, n = message.encode_parts()
    # tpu-lint: disable=WIRE-COPY the one gather of the frame
    return b"".join([frame_header(n), *parts])


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
    ``chunks``, as soon as its last byte is in.  A chunk of whole frames
    is sliced, not copied.  A body that ends inside a frame raises
    ValueError."""
    buf = bytearray()
    for chunk in chunks:
        if not buf:
            mv = memoryview(chunk)
            pos = 0
            while len(mv) - pos >= 5:
                flags, n = struct.unpack_from(">BI", mv, pos)
                if len(mv) - pos - 5 < n:
                    break
                yield flags, mv[pos + 5:pos + 5 + n]
                pos += 5 + n
            buf += mv[pos:]
            continue
        buf += chunk
        while len(buf) >= 5:
            flags, n = struct.unpack_from(">BI", buf, 0)
            if len(buf) < 5 + n:
                break
            payload = bytes(buf[5:5 + n])
            del buf[:5 + n]
            yield flags, memoryview(payload)
    if buf:
        raise ValueError("truncated grpc-web frame")
