"""The v2 gRPC service's method table, without ``grpc``.

Counterpart of ``triton_client_tpu/protocol/service.py:17-60``: the full
method names are ``/inference.GRPCInferenceService/<Method>``, each with
its arity (``"uu"`` unary, ``"ss"`` a bidirectional stream) and its request
and response message classes (``inference.py``).  The port serves them as
gRPC-Web on its HTTP/1.1 port (``server/grpc_web.py``).  The reference's
debug RPCs (``FlightRecorder``, ``DeviceStats``, ``Costs``) take their
messages from ``debug.py``.
"""

from __future__ import annotations

import enum

from . import debug as pb_debug
from . import inference as pb

SERVICE_NAME = "inference.GRPCInferenceService"

#: method name -> (arity, request type, response type)
METHODS = {
    name: (arity, getattr(pb, name + "Request") if name != "ModelStreamInfer"
           else pb.ModelInferRequest,
           getattr(pb, name + "Response") if name != "ModelStreamInfer"
           else pb.ModelStreamInferResponse)
    for name, arity in (
        ("ServerLive", "uu"), ("ServerReady", "uu"), ("ModelReady", "uu"),
        ("ServerMetadata", "uu"), ("ModelMetadata", "uu"),
        ("ModelInfer", "uu"), ("ModelStreamInfer", "ss"),
        ("ModelConfig", "uu"), ("ModelStatistics", "uu"),
        ("RepositoryIndex", "uu"), ("RepositoryModelLoad", "uu"),
        ("RepositoryModelUnload", "uu"),
        ("SystemSharedMemoryStatus", "uu"),
        ("SystemSharedMemoryRegister", "uu"),
        ("SystemSharedMemoryUnregister", "uu"),
        ("CudaSharedMemoryStatus", "uu"), ("CudaSharedMemoryRegister", "uu"),
        ("CudaSharedMemoryUnregister", "uu"), ("TraceSetting", "uu"),
        ("LogSettings", "uu"))
}
METHODS.update({
    name: ("uu", getattr(pb_debug, name + "Request"),
           getattr(pb_debug, name + "Response"))
    for name in ("FlightRecorder", "DeviceStats", "Costs")})

def path(method: str) -> str:
    """The HTTP path of ``method``."""
    return f"/{SERVICE_NAME}/{method}"


class StatusCode(enum.IntEnum):
    """gRPC status codes; ``str()`` spells them as ``grpc.StatusCode``
    does (``"StatusCode.INVALID_ARGUMENT"``)."""

    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16

    def __str__(self) -> str:
        return f"StatusCode.{self.name}"

    @classmethod
    def of(cls, code: int) -> "StatusCode":
        """The code, UNKNOWN where the number is not one."""
        try:
            return cls(code)
        except ValueError:
            return cls.UNKNOWN
