"""The client's stream (counterpart of
``triton_client_tpu/grpc/_infer_stream.py``): one duplex
``ModelStreamInfer`` call on the client's transport (a stream of its
HTTP/2 connection, ``_h2_transport.H2StreamCall``, or a gRPC-Web socket,
``_transport.StreamCall``) whose responses reach
the user's callback on the reader thread, in order, as ``callback(result,
error)``.  An in-band error (``error_message``) is an error for its
request only; a non-OK status of the call ends the stream, and later
sends raise.  A stream opened with a deadline (``stream_timeout``) ends
with DEADLINE_EXCEEDED when it passes.  Under an ``encoding`` every
request frame goes compressed."""

from __future__ import annotations

from typing import Callable, Optional

from ..protocol import inference as pb
from ..utils import InferenceServerException, raise_error
from ..protocol.grpc_web import compress_frame
from ._infer_result import InferResult
from ._utils import stream_error_to_exception
from ..protocol.service import StatusCode


class _InferStream:
    def __init__(self, transport, callback: Callable, headers: dict,
                 verbose: bool = False, deadline_s=None,
                 encoding: Optional[str] = None):
        self._callback = callback
        self._verbose = verbose
        self._active = True
        self._encoding = encoding
        if encoding is not None:
            headers = {**headers, "grpc-encoding": encoding}
        self._call = transport.open_stream("ModelStreamInfer", headers,
                                           self._on_message, self._on_end,
                                           deadline_s=deadline_s)

    def _on_message(self, payload: bytes) -> None:
        response = pb.ModelStreamInferResponse.FromString(payload)
        if self._verbose:
            print(response)
        if response.error_message:
            self._callback(result=None,
                           error=stream_error_to_exception(
                               response.error_message))
        else:
            self._callback(result=InferResult(response.infer_response),
                           error=None)

    def _on_end(self, code: StatusCode, message: str) -> None:
        if code == StatusCode.OK:
            return
        self._active = False
        self._callback(result=None, error=InferenceServerException(
            msg=message, status=str(code)))

    def send(self, frame: bytes) -> None:
        """Send one encoded request frame on the stream."""
        if not self._active:
            raise_error("The stream is no longer in valid state, the error "
                        "detail is reported through provided callback. A "
                        "new stream should be started after stopping the "
                        "current stream.")
        if self._encoding is not None:
            frame = compress_frame(frame, self._encoding)
        self._call.send(frame)

    def close(self, cancel_requests: bool = False) -> None:
        """End the stream: with ``cancel_requests``, at once (requests in
        flight get one CANCELLED error); else after the server has
        answered every request sent."""
        if cancel_requests:
            self._call.cancel()
        else:
            self._call.close_send()
        self._call.join()
        self._call.close()
        self._active = False
        if self._verbose:
            print("stream stopped...")
