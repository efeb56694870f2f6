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

The call itself (the cap, the encodings, unary against stream, the
status) is ``grpc_server.py``'s, which the HTTP/2 listener
(``grpc_h2.py``) shares; this module is the gRPC-Web transport around it:
the frames in an HTTP/1.1 body, and the trailers as a 0x80 frame.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

from ..protocol.grpc_web import (CONTENT_TYPE, CONTENT_TYPES, frame_header,
                                 trailers)
from ..protocol.service import METHODS, StatusCode
from .grpc_server import (GrpcError, InferenceServicer, check_encoding,
                          request_messages, status_of, stream_responses,
                          unary_response)


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
    try:
        encoding = check_encoding(metadata)
    except GrpcError as e:
        for _ in chunks:
            pass
        send(200, trailers(e.code, e.message),
             {"grpc-status": str(int(e.code))}, CONTENT_TYPE)
        return
    if METHODS[method][0] == "uu":
        _unary(servicer, method, chunks, send, metadata, encoding)
    else:
        _stream(servicer, method, chunks, start_stream(), metadata,
                encoding)


def _unary(servicer, method, chunks, send, metadata, encoding) -> None:
    out: list = []
    status, message, trailing = StatusCode.OK, "", {}
    try:
        messages = request_messages(chunks, encoding,
                                    servicer.max_request_bytes)
        first = next(messages, None)
        for _ in messages:  # read the body to its end
            pass
        parts, n = unary_response(servicer, method, first, metadata)
        out = [frame_header(n), *parts]
    except Exception as e:  # noqa: BLE001 - the call's status
        out = []
        status, message, trailing = status_of(e)
    out.append(trailers(status, message, trailing))
    # tpu-lint: disable=WIRE-COPY the one gather of the response frames
    send(200, b"".join(out), {"grpc-status": str(int(status))},
         CONTENT_TYPE)


def _stream(servicer, method, chunks, write, metadata, encoding) -> None:
    status, message, trailing = StatusCode.OK, "", {}
    try:
        messages = request_messages(chunks, encoding,
                                    servicer.max_request_bytes)
        for parts, n in stream_responses(servicer, method, messages,
                                         metadata):
            # tpu-lint: disable=WIRE-COPY one chunk per response frame
            write(b"".join([frame_header(n), *parts]))
    except (BrokenPipeError, ConnectionResetError):
        raise  # the client went away: nothing left to answer
    except Exception as e:  # noqa: BLE001 - the stream's status
        status, message, trailing = status_of(e)
    write(trailers(status, message, trailing))
    write(b"")
