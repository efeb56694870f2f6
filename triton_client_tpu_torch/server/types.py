"""Transport-neutral request/response model for the serving harness.

The port's own copy of ``triton_client_tpu/server/types.py`` (pure Python;
kept field for field so the two packages' requests and responses mean the
same thing).  This slice's HTTP frontend (``http_server.py``) decodes into
these structures and the core (``core.py``) only ever sees them.  The
frontends resolve a request's deadline and priority with
:func:`apply_request_deadline` and :func:`apply_request_priority`, and its
tenant with ``qos.tenant_from_headers``.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..utils import (bf16_from_bytes, deserialize_bytes_tensor,
                     triton_to_np_dtype)


@dataclass
class InputTensor:
    name: str
    datatype: str
    shape: Tuple[int, ...]
    # Exactly one of `data` (decoded ndarray) / `shm` (region reference).
    data: Optional[np.ndarray] = None
    shm: Optional["ShmRef"] = None
    parameters: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ShmRef:
    region_name: str
    byte_size: int
    offset: int = 0


@dataclass
class RequestedOutput:
    name: str
    binary_data: bool = True  # HTTP only: whether to return binary or JSON
    class_count: int = 0
    shm: Optional[ShmRef] = None
    parameters: Dict[str, Any] = field(default_factory=dict)


@dataclass
class InferRequest:
    model_name: str
    model_version: str = ""
    id: str = ""
    inputs: List[InputTensor] = field(default_factory=list)
    outputs: List[RequestedOutput] = field(default_factory=list)
    parameters: Dict[str, Any] = field(default_factory=dict)
    # Trace propagation (client telemetry layer): the frontend fills these
    # from the `triton-request-id` / `traceparent` header (gRPC metadata);
    # the tracer records them and the response echoes the id back.
    client_request_id: str = ""
    traceparent: str = ""
    # Wire-decode window (span tracing): the frontend stamps when it began
    # and finished decoding the wire request so a sampled trace gets a
    # DECODE child span.  0 = frontend did not instrument decode.
    decode_start_ns: int = 0
    decode_end_ns: int = 0
    # A frontend that sets this owns trace finalization: the core hands the
    # sampled TraceContext back on the response (InferResponse.trace) so
    # SERIALIZE/NETWORK_WRITE spans land inside the emitted record.  Paths
    # that never finalize (generate, OpenAI, streaming) leave it False and
    # the core emits at the end of its own envelope, as before.
    trace_handoff: bool = False
    # Which wire the request arrived on ("http" / "grpc"; "" for in-process
    # callers) — recorded per request by the flight recorder.
    protocol: str = ""
    # Wire payload size (bytes) as received by the frontend (HTTP body
    # length / gRPC message ByteSize; 0 for in-process callers).  The
    # memory governor (server/memory.py) reserves this against the host
    # byte budget at admission and releases it when the envelope
    # completes.
    wire_bytes: int = 0
    # Absolute deadline on the server's monotonic clock (0 = none).  The
    # frontends derive it from the v2 `timeout` request parameter
    # (microseconds; both protocols) or the `triton-timeout-us` HTTP
    # header — the wire forms the client resilience layer propagates its
    # remaining deadline budget through.  An expired request is dropped at
    # dequeue / batch assembly without entering COMPUTE.
    deadline_ns: int = 0
    # -- QoS (server/qos.py) ----------------------------------------------
    # Tenant id resolved by the frontend (triton-tenant header, then the
    # basic-auth username, then "anonymous" — filled by the core if the
    # frontend left it empty).
    tenant: str = ""
    # v2 request priority (0 = highest), consumed out of `parameters` by
    # the frontend so priority never splits dynamic-batch parameter
    # groups; `tier` is the admission-resolved QoS class.
    priority: int = 0
    tier: int = 0
    # Filled by the core:
    arrival_ns: int = field(default_factory=lambda: time.monotonic_ns())

    def expired(self, now_ns: Optional[int] = None) -> bool:
        """Whether this request's deadline has already passed."""
        if not self.deadline_ns:
            return False
        return (now_ns if now_ns is not None
                else time.monotonic_ns()) >= self.deadline_ns

    @property
    def sequence_id(self):
        return self.parameters.get("sequence_id", 0)

    @property
    def sequence_start(self) -> bool:
        return bool(self.parameters.get("sequence_start", False))

    @property
    def sequence_end(self) -> bool:
        return bool(self.parameters.get("sequence_end", False))


@dataclass
class OutputTensor:
    name: str
    datatype: str
    shape: Tuple[int, ...]
    # Host ndarray at the frontend boundary (BF16: a torch.bfloat16 CPU
    # tensor); None when the output was delivered through a shared-memory
    # region (the core wrote it there and the frontend must emit only shm
    # params, no data):
    data: Optional[Any]
    shm: Optional[ShmRef] = None
    parameters: Dict[str, Any] = field(default_factory=dict)


@dataclass
class InferResponse:
    model_name: str
    model_version: str
    id: str = ""
    outputs: List[OutputTensor] = field(default_factory=list)
    parameters: Dict[str, Any] = field(default_factory=dict)
    # Sampled TraceContext handed to a finalizing frontend (see
    # InferRequest.trace_handoff); never serialized onto the wire.
    trace: Any = None


class InferError(Exception):
    """Server-side inference error with an HTTP status / gRPC code mapping.

    ``retry_after_s`` carries server pushback for shed load (HTTP 429 →
    ``Retry-After`` header; gRPC RESOURCE_EXHAUSTED → ``retry-after-ms``
    trailing metadata) so a well-behaved client backs off for exactly the
    horizon the server asked for."""

    def __init__(self, msg: str, http_status: int = 400,
                 retry_after_s: Optional[float] = None):
        super().__init__(msg)
        self.http_status = http_status
        self.retry_after_s = retry_after_s
        # why admission refused this request ("memory" for byte-budget /
        # HBM-headroom sheds) — stamped onto the flight record so an
        # operator can tell memory sheds from queue-depth sheds
        self.shed_reason: Optional[str] = None


def apply_request_deadline(req: InferRequest,
                           header_us: Optional[str] = None) -> None:
    """Resolve a request's server-side deadline from its wire forms.

    The v2 ``timeout`` request parameter (microseconds, both protocols) is
    *consumed* here — it describes the transport contract, not the model,
    and leaving it in ``parameters`` would split dynamic-batch parameter
    groups per-deadline.  ``header_us`` is the HTTP ``triton-timeout-us``
    header, which wins over the body parameter when both are present (the
    header is restamped per retry attempt with the shrunken budget)."""
    raw = req.parameters.pop("timeout", None)
    if header_us is not None:
        raw = header_us
    if raw is None:
        return
    try:
        us = int(raw)
    except (TypeError, ValueError):
        raise InferError(
            f"invalid request timeout {raw!r}: expected an integer "
            "microseconds value")
    if us > 0:
        req.deadline_ns = time.monotonic_ns() + us * 1000


def apply_request_priority(req: InferRequest) -> None:
    """Consume the v2 ``priority`` request parameter (0 = highest) into
    ``req.priority``.  Consumed, like ``timeout``: priority steers dequeue
    order, not model semantics, and leaving it in ``parameters`` would
    split dynamic-batch parameter groups per priority class."""
    raw = req.parameters.pop("priority", None)
    if raw is None:
        return
    try:
        priority = int(raw)
    except (TypeError, ValueError):
        priority = -1  # fall through to the one rejection path below
    if priority < 0:
        # rejected, not clamped: a negative priority silently promoted to
        # tier 0 would grant preemption rights to malformed input (and
        # gRPC's uint64 param already rejects it client-side — both
        # protocols must agree)
        raise InferError(
            f"invalid request priority {raw!r}: expected a non-negative "
            "integer")
    req.priority = priority


def reshape_input(arr: np.ndarray, shape, name: str) -> np.ndarray:
    """Reshape client-provided tensor data, failing as a client error (HTTP
    400 / gRPC InvalidArgument) instead of an escaped ValueError."""
    try:
        return arr.reshape(shape)
    except (ValueError, TypeError) as e:
        raise InferError(
            f"invalid shape {list(shape)} for input '{name}': {e}")


def numeric_dtype(datatype: str, name: str) -> np.dtype:
    dt = triton_to_np_dtype(datatype)
    if dt is None:
        raise InferError(
            f"unsupported datatype '{datatype}' for input '{name}'")
    return dt


def bytes_to_array(chunk, datatype: str, shape, name: str):
    """A tensor's raw wire bytes (HTTP binary data, gRPC
    ``raw_input_contents``) as an array of its shape: a view for a numeric
    datatype, BYTES elements decoded, BF16 a ``torch.bfloat16`` tensor; a
    malformed payload is a 400."""
    if datatype == "BF16":
        expected = math.prod(shape) * 2
        if len(chunk) != expected:
            raise InferError(
                f"unexpected total byte size {len(chunk)} for input "
                f"'{name}', expecting {expected}")
        return bf16_from_bytes(chunk, shape)
    if datatype == "BYTES":
        try:
            flat = deserialize_bytes_tensor(chunk)
        except ValueError as e:
            raise InferError(
                f"malformed BYTES payload for input '{name}': {e}")
        return reshape_input(flat, shape, name)
    dt = numeric_dtype(datatype, name)
    expected = math.prod(shape) * dt.itemsize
    if len(chunk) != expected:
        raise InferError(
            f"unexpected total byte size {len(chunk)} for input '{name}', "
            f"expecting {expected}")
    return reshape_input(np.frombuffer(chunk, dtype=dt), shape, name)
