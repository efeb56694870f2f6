"""gRPC-Web bridge: the v2 gRPC service on the port's HTTP/1.1 server.

Counterpart of ``triton_client_tpu/server/grpc_web.py``.  The machine the
port serves on has no ``grpcio`` and the standard library has no HTTP/2
server, so the port serves gRPC as gRPC-Web on its HTTP port, where the
reference mounts its bridge:

* ``POST /inference.GRPCInferenceService/<Method>`` with a body of
  ``application/grpc-web+proto`` (or ``application/grpc-web``,
  ``application/grpc``; any other content type is a 415);
* frames of ``<1 byte flags><4 bytes big-endian length><message>``; the
  answer ends with a trailers frame (flags 0x80) holding ``grpc-status``
  and a percent-encoded ``grpc-message``;
* a unary call: one request frame, one response frame, the trailers, and
  ``grpc-status`` also as a header;
* ``ModelStreamInfer``, a duplex stream over chunked transfer coding both
  ways: the request frames are read as their chunks arrive and each request
  is answered (its frames written as chunks) before the next is read, as
  the reference's ``async for`` does, so a client can send its next request
  after the last answer (a generation loop).  A body with a
  ``Content-Length`` works too (all requests sent at once).

The HTTP headers are the call's metadata (``triton-tenant``,
``authorization``, the trace headers).  A refusal with pushback carries
``retry-after-ms`` in its trailers, as the reference's servicer sets it
in its trailing metadata.  A request message larger than the servicer's
``max_request_bytes`` is not decoded: RESOURCE_EXHAUSTED on a unary call,
an in-band ``[413]`` error on a stream.

A compressed request frame (flag bit 0x01) is inflated in the call's
``grpc-encoding`` (``gzip`` or ``deflate``) under the same cap, counted on
the inflated bytes as a compressed HTTP body is; a call that names any
other encoding is answered UNIMPLEMENTED, as grpcio's server answers it.
Answers go back uncompressed.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, List, Optional

from ..protocol.grpc_web import (COMPRESSED_FLAG, CONTENT_TYPE,
                                 CONTENT_TYPES, ENCODINGS, TRAILER_FLAG,
                                 frame_header, inflate, iter_frames,
                                 trailers)
from ..protocol.service import METHODS, StatusCode
from .grpc_server import GrpcError, InferenceServicer, oversize_error


def _messages(chunks: Iterable[bytes], encoding: str, cap: int):
    """(message, size) of each data frame of a request body (client
    trailers skipped): a compressed frame inflated in ``encoding``; the
    message None where its size passes ``cap`` (it is not decoded)."""
    for flags, payload in iter_frames(chunks):
        if flags & TRAILER_FLAG:
            continue
        if flags & COMPRESSED_FLAG:
            if encoding not in ENCODINGS:
                raise GrpcError(StatusCode.INTERNAL,
                                "compressed message without a grpc-encoding")
            payload = inflate(payload, encoding, cap)
        size = len(payload)
        yield (None if cap and size > cap else payload), size


def _status_of(e: Exception):
    if isinstance(e, GrpcError):
        return e.code, e.message, e.trailing
    return StatusCode.INTERNAL, str(e), {}


def serve(servicer: InferenceServicer, method: str, content_type: str,
          chunks: Iterable[bytes], send: Callable,
          start_stream: Callable[[], Callable[[bytes], None]],
          metadata: Optional[Dict[str, str]] = None) -> None:
    """Answer one gRPC-Web call on an HTTP exchange.

    ``chunks`` yields the request body as it arrives; ``send(status,
    payload, headers, content_type)`` writes a whole response;
    ``start_stream()`` writes a chunked response's head and returns the
    function that writes one chunk (``b""`` ends the body); ``metadata``:
    the request's headers, their names in lower case."""
    metadata = metadata or {}
    if content_type.split(";", 1)[0].strip() not in CONTENT_TYPES:
        for _ in chunks:  # the body is read whole on every path
            pass
        send(415, f"unsupported content type {content_type}".encode(),
             {}, "text/plain; charset=utf-8")
        return
    arity, req_type, _ = METHODS[method]
    encoding = metadata.get("grpc-encoding", "identity").strip().lower()
    if encoding not in ("identity", *ENCODINGS):
        for _ in chunks:
            pass
        send(200, trailers(StatusCode.UNIMPLEMENTED,
                           f"Compression algorithm '{encoding}' is not "
                           "supported"),
             {"grpc-status": str(int(StatusCode.UNIMPLEMENTED))},
             CONTENT_TYPE)
        return
    if arity == "uu":
        _unary(servicer, method, req_type, chunks, send, metadata, encoding)
    else:
        _stream(servicer, method, req_type, chunks, start_stream(),
                metadata, encoding)


def _unary(servicer, method, req_type, chunks, send, metadata,
           encoding) -> None:
    out: List = []
    status, message, trailing = StatusCode.OK, "", {}
    cap = servicer.max_request_bytes
    try:
        frames = _messages(chunks, encoding, cap)
        first = next(frames, None)
        for _ in frames:  # read the body to its end
            pass
        if first is None:
            raise ValueError("missing request message")
        payload, size = first
        if payload is None:
            raise oversize_error(size, cap)
        t0 = time.monotonic_ns()
        request = req_type.FromString(payload)
        if method == "ModelInfer":
            resp = servicer.ModelInfer(request, len(payload), t0, metadata)
        else:
            resp = getattr(servicer, method)(request)
        parts, n = resp.encode_parts()
        out = [frame_header(n), *parts]
    except Exception as e:  # noqa: BLE001 - the call's status
        out = []
        status, message, trailing = _status_of(e)
    out.append(trailers(status, message, trailing))
    # tpu-lint: disable=WIRE-COPY the one gather of the response frames
    send(200, b"".join(out), {"grpc-status": str(int(status))},
         CONTENT_TYPE)


def _stream(servicer, method, req_type, chunks, write, metadata,
            encoding) -> None:
    status, message, trailing = StatusCode.OK, "", {}
    cap = servicer.max_request_bytes
    try:
        # (request, wire bytes); a message over the cap is not decoded
        requests = ((None if p is None else req_type.FromString(p), n)
                    for p, n in _messages(chunks, encoding, cap))
        for resp in getattr(servicer, method)(requests, metadata):
            parts, n = resp.encode_parts()
            # tpu-lint: disable=WIRE-COPY one chunk per response frame
            write(b"".join([frame_header(n), *parts]))
    except (BrokenPipeError, ConnectionResetError):
        raise  # the client went away: nothing left to answer
    except Exception as e:  # noqa: BLE001 - the stream's status
        status, message, trailing = _status_of(e)
    write(trailers(status, message, trailing))
    write(b"")
