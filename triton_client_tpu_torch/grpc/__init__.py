"""gRPC client of the v2 inference protocol (counterpart of
``triton_client_tpu.grpc``), over gRPC-Web on HTTP/1.1: the port's own
proto3 messages (``service_pb2`` and ``model_config_pb2`` name them, as
the reference's aliases do) and no ``grpcio``.  Its asyncio client is
``grpc.aio``, gRPC-Web on the same transport as ``http.aio``."""

from .._auth import BasicAuth  # noqa: F401 (exported as the reference does)
from ..protocol import inference as model_config_pb2
from ..protocol import inference as service_pb2
from ._client import (CallContext, InferAsyncRequest, InferenceServerClient,
                      KeepAliveOptions, PreparedRequest)
from ._infer_input import InferInput
from ._infer_result import InferResult
from ._requested_output import InferRequestedOutput

__all__ = [
    "InferenceServerClient",
    "InferAsyncRequest",
    "CallContext",
    "KeepAliveOptions",
    "InferInput",
    "InferRequestedOutput",
    "InferResult",
    "PreparedRequest",
    "service_pb2",
    "model_config_pb2",
]
