"""gRPC client helpers (counterpart of ``triton_client_tpu/grpc/_utils.py``):
the request message, and errors as ``InferenceServerException`` with the
``grpc.StatusCode`` spelling of their status (``"StatusCode.NOT_FOUND"``),
in-band stream errors included."""

from __future__ import annotations

import re

from ..protocol import inference as pb
from ..utils import InferenceServerException, raise_error

_RESERVED_PARAMS = ("sequence_id", "sequence_start", "sequence_end",
                    "priority", "binary_data_output")


def get_error_grpc(rpc_error) -> InferenceServerException:
    """An ``RpcError`` (``_transport.RpcError``) as the client's exception;
    the server's ``retry-after-ms`` trailer as its ``retry_after_s``."""
    exc = InferenceServerException(msg=rpc_error.details(),
                                   status=str(rpc_error.code()))
    for key, value in rpc_error.trailing_metadata():
        if key == "retry-after-ms":
            try:
                exc.retry_after_s = float(value) / 1e3
            except ValueError:
                pass
    return exc


def raise_error_grpc(rpc_error):
    raise get_error_grpc(rpc_error) from None


#: an in-band stream error's "[NNN] " prefix -> the unary status spelling,
#: so stream failures classify as unary ones do
_STREAM_STATUS = {
    "400": "StatusCode.INVALID_ARGUMENT",
    "404": "StatusCode.NOT_FOUND",
    "413": "StatusCode.RESOURCE_EXHAUSTED",
    "429": "StatusCode.RESOURCE_EXHAUSTED",
    "500": "StatusCode.INTERNAL",
    "503": "StatusCode.UNAVAILABLE",
    "504": "StatusCode.DEADLINE_EXCEEDED",
}


def stream_error_to_exception(message: str) -> InferenceServerException:
    """The exception of one in-band ``ModelStreamInferResponse`` error; an
    unprefixed message has no status."""
    m = re.match(r"\[(\d{3})\] ", message)
    status = _STREAM_STATUS.get(m.group(1)) if m else None
    return InferenceServerException(msg=message, status=status)


def _param(value) -> "pb.InferParameter":
    if isinstance(value, bool):
        return pb.InferParameter(bool_param=value)
    if isinstance(value, int):
        return pb.InferParameter(int64_param=value)
    if isinstance(value, float):
        return pb.InferParameter(double_param=value)
    if isinstance(value, str):
        return pb.InferParameter(string_param=value)
    raise TypeError(type(value).__name__)


def get_inference_request(model_name, inputs, model_version, request_id,
                          outputs, sequence_id, sequence_start, sequence_end,
                          priority, timeout, parameters
                          ) -> "pb.ModelInferRequest":
    """The ``ModelInferRequest``: tensors, and one ``raw_input_contents``
    entry per input that carries data (views of the inputs' bytes, not
    copies); a string ``sequence_id`` is a ``string_param``."""
    request = pb.ModelInferRequest(model_name=model_name,
                                   model_version=model_version)
    if request_id:
        request.id = request_id
    if sequence_id:
        request.parameters["sequence_id"] = (
            pb.InferParameter(string_param=sequence_id)
            if isinstance(sequence_id, str)
            else pb.InferParameter(int64_param=sequence_id))
        request.parameters["sequence_start"] = pb.InferParameter(
            bool_param=sequence_start)
        request.parameters["sequence_end"] = pb.InferParameter(
            bool_param=sequence_end)
    if priority:
        request.parameters["priority"] = pb.InferParameter(
            uint64_param=priority)
    if timeout is not None:
        request.parameters["timeout"] = pb.InferParameter(
            int64_param=timeout)
    for inp in inputs:
        request.inputs.append(inp._get_tensor_pb())
        raw = inp._get_raw_data()
        if raw is not None:
            request.raw_input_contents.append(raw)
    for out in outputs or ():
        request.outputs.append(out._get_tensor_pb())
    for key, value in (parameters or {}).items():
        if key in _RESERVED_PARAMS:
            raise_error(f"Parameter {key!r} is a reserved parameter and "
                        "cannot be specified.")
        try:
            request.parameters[key] = _param(value)
        except TypeError:
            raise_error(f"Unsupported parameter type for {key!r}")
    return request
