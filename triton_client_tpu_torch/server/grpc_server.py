"""The v2 gRPC service of the port (``inference.GRPCInferenceService``).

Counterpart of ``triton_client_tpu/server/grpc_server.py:61-644``, on the
port's own messages (``protocol/inference.py``) and without ``grpc``: the
port serves it over HTTP/2 on its gRPC port (``grpc_h2.py``) and as
gRPC-Web on its HTTP/1.1 port (``grpc_web.py``).  An RPC is a method that
takes the decoded request message and returns the response message, or
raises :class:`GrpcError` with a status code; the stream RPC takes an
iterator of requests and yields responses.

The call itself, whichever transport carries it, is here too
(:func:`check_encoding`, :func:`request_messages`,
:func:`unary_response`, :func:`stream_responses`, :func:`status_of`): a
message over the ingress cap is not decoded, a compressed one is
inflated in the call's ``grpc-encoding`` (gzip or deflate; any other is
UNIMPLEMENTED) under the same cap, a unary call answers its one message
and a stream each request in turn, and a failure becomes the call's
status, message and trailing metadata.

* ``ModelInfer`` decodes a ``ModelInferRequest`` into the core's
  :class:`InferRequest`: ``raw_input_contents`` holds one entry per input
  that is not in a shared-memory region, in input order (the count is
  checked); typed ``contents`` are the fallback; shared-memory parameters
  become :class:`ShmRef`\\ s.  The response carries each output's bytes in
  ``raw_output_contents`` (views of the output arrays, not copies), an
  empty entry for an output written to a region; it is stamped from the
  core's gRPC template cache (``wire.py``,
  ``InferenceCore.grpc_wire_templates``), byte for byte the slow path's
  ``build_pb_response``.
* ``ModelStreamInfer`` answers each request in turn (a decoupled model:
  0..N responses, and the empty final one where the request asks for it),
  errors in-band as ``"[NNN] message"`` (the HTTP status of the core's
  error).
* Health, metadata, ``ModelConfig`` (the config as a proto ``ModelConfig``),
  ``ModelStatistics`` (``InferenceCore.statistics``) and the six shared
  memory RPCs, on the registries of ``shm.py``, with the HTTP routes'
  texts.
* ``TraceSetting`` and ``LogSettings`` (the reference's contracts: an
  empty value clears a trace key to its default, or in a model's scope to
  the global value), and the debug RPCs ``FlightRecorder``,
  ``DeviceStats`` and ``Costs``, whose responses carry the HTTP routes'
  JSON.  A traced ``ModelInfer`` is finished here: SERIALIZE (the response
  message built) and NETWORK_WRITE (until it is handed to the bridge); a
  traced decoupled stream gets a NETWORK_WRITE span every few chunks.
* The repository RPCs (the reference's, grpc_server.py:263-310):
  ``RepositoryIndex``, ``RepositoryModelLoad`` (a ``config`` string
  parameter and ``file:<path>`` bytes parameters) and
  ``RepositoryModelUnload`` (``unload_dependents``), a failure INTERNAL
  with the core's text, as in the reference.

Status codes from the core's errors as in the reference's ``_grpc_code``:
413 and 429 RESOURCE_EXHAUSTED, 503 UNAVAILABLE, 504 DEADLINE_EXCEEDED; a
refusal with pushback carries ``retry-after-ms`` in its trailing metadata
(grpc_server.py:523-530).  The tenant comes from the ``triton-tenant`` or
``authorization`` metadata (:42-58), the deadline and priority from the
request's ``timeout`` and ``priority`` parameters.
"""

from __future__ import annotations

import base64
import json
import time
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from ..protocol import debug as pb_debug
from ..protocol import inference as pb
from ..protocol.grpc_web import (COMPRESSED_FLAG, ENCODINGS, TRAILER_FLAG,
                                 inflate, iter_messages)
from ..protocol.service import METHODS, StatusCode
from ..utils import triton_to_np_dtype
from .core import InferenceCore
from .flight_recorder import parse_snapshot_limit
from .memory import oversize_message
from .qos import tenant_from_headers
from .trace import TRACE_DEFAULTS, validate_trace_update
from .types import (InferError, InferRequest, InferResponse, InputTensor,
                    RequestedOutput, ShmRef, apply_request_deadline,
                    apply_request_priority, bytes_to_array, reshape_input)
from .wire import encode_pb_response


class GrpcError(Exception):
    """An RPC's non-OK status, its message and its trailing metadata."""

    def __init__(self, code: StatusCode, message: str,
                 trailing: Optional[Dict[str, str]] = None):
        super().__init__(message)
        self.code = code
        self.message = message
        self.trailing = trailing or {}

    @classmethod
    def of(cls, e: InferError) -> "GrpcError":
        """A core error as a status; its pushback as ``retry-after-ms``."""
        trailing = {}
        if e.retry_after_s is not None:
            trailing["retry-after-ms"] = str(int(e.retry_after_s * 1000))
        return cls(grpc_code(e), str(e), trailing)


def oversize_error(size: int, cap: int) -> GrpcError:
    """The ingress cap's refusal of one message: RESOURCE_EXHAUSTED whose
    text marks it as an oversize (never retried)."""
    return GrpcError(StatusCode.RESOURCE_EXHAUSTED,
                     oversize_message(size, cap))


def grpc_code(e: InferError) -> StatusCode:
    """The status of a core error, by its HTTP status (the reference's
    ``_grpc_code``)."""
    return {
        400: StatusCode.INVALID_ARGUMENT,
        404: StatusCode.NOT_FOUND,
        413: StatusCode.RESOURCE_EXHAUSTED,
        429: StatusCode.RESOURCE_EXHAUSTED,
        503: StatusCode.UNAVAILABLE,
        504: StatusCode.DEADLINE_EXCEEDED,
        500: StatusCode.INTERNAL,
    }.get(e.http_status, StatusCode.UNKNOWN)


def param_to_py(p) -> Any:
    which = p.WhichOneof("parameter_choice")
    return getattr(p, which) if which else None


def _shm_ref(params: Dict[str, Any], what: str, name: str) -> ShmRef:
    try:
        return ShmRef(region_name=params["shared_memory_region"],
                      byte_size=int(params["shared_memory_byte_size"]),
                      offset=int(params.get("shared_memory_offset", 0)))
    except (KeyError, TypeError, ValueError) as e:
        raise InferError(
            f"malformed shared-memory parameters for {what} '{name}': {e}")


_CONTENTS_FIELD = {
    "BOOL": "bool_contents", "INT8": "int_contents",
    "INT16": "int_contents", "INT32": "int_contents",
    "INT64": "int64_contents", "UINT8": "uint_contents",
    "UINT16": "uint_contents", "UINT32": "uint_contents",
    "UINT64": "uint64_contents", "FP32": "fp32_contents",
    "FP64": "fp64_contents", "BYTES": "bytes_contents",
}


def _contents_to_array(contents, datatype: str, shape, name: str):
    field = _CONTENTS_FIELD.get(datatype)
    if field is None:
        raise InferError(f"typed contents not supported for datatype "
                         f"'{datatype}' (input '{name}')")
    values = getattr(contents, field)
    if datatype == "BYTES":
        return reshape_input(np.array([bytes(v) for v in values],
                                      dtype=np.object_), shape, name)
    return reshape_input(np.array(values, dtype=triton_to_np_dtype(datatype)),
                         shape, name)


def decode_request(request: "pb.ModelInferRequest") -> InferRequest:
    """A ``ModelInferRequest`` as the core's :class:`InferRequest`."""
    req = InferRequest(
        model_name=request.model_name, model_version=request.model_version,
        id=request.id,
        parameters={k: param_to_py(v)
                    for k, v in request.parameters.items()})
    raw = request.raw_input_contents
    n_raw = sum(1 for t in request.inputs
                if "shared_memory_region" not in t.parameters)
    if raw and len(raw) != n_raw:
        raise InferError(
            "raw_input_contents does not match the number of non-shared-"
            f"memory inputs (got {len(raw)}, expected {n_raw})")
    raw_idx = 0
    for t in request.inputs:
        shape = tuple(int(s) for s in t.shape)
        params = {k: param_to_py(v) for k, v in t.parameters.items()}
        tensor = InputTensor(name=t.name, datatype=t.datatype, shape=shape,
                             parameters=params)
        if params.get("shared_memory_region"):
            tensor.shm = _shm_ref(params, "input", t.name)
        elif raw:
            tensor.data = bytes_to_array(raw[raw_idx], t.datatype, shape,
                                         t.name)
            raw_idx += 1
        elif t.contents is not None:
            tensor.data = _contents_to_array(t.contents, t.datatype, shape,
                                             t.name)
        else:
            raise InferError(f"input '{t.name}' has no data")
        req.inputs.append(tensor)
    for o in request.outputs:
        params = {k: param_to_py(v) for k, v in o.parameters.items()}
        out = RequestedOutput(name=o.name,
                              class_count=int(params.get("classification",
                                                         0)),
                              parameters=params)
        if params.get("shared_memory_region"):
            out.shm = _shm_ref(params, "output", o.name)
        req.outputs.append(out)
    return req


def _statistic(count: int, ns: int) -> "pb.StatisticDuration":
    return pb.StatisticDuration(count=count, ns=ns)


class InferenceServicer:
    """The RPCs of the v2 service on one :class:`InferenceCore`."""

    def __init__(self, core: InferenceCore, max_request_bytes: int = 0):
        self._core = core
        #: the ingress cap on one request message (0: none)
        self.max_request_bytes = max_request_bytes

    # -- health / metadata -------------------------------------------------
    def ServerLive(self, request):
        return pb.ServerLiveResponse(live=self._core.live)

    def ServerReady(self, request):
        return pb.ServerReadyResponse(ready=self._core.ready())

    def ModelReady(self, request):
        return pb.ModelReadyResponse(
            ready=self._core.model_ready(request.name, request.version))

    def ServerMetadata(self, request):
        md = self._core.server_metadata()
        return pb.ServerMetadataResponse(name=md["name"],
                                         version=md["version"],
                                         extensions=md["extensions"])

    def _model(self, request):
        try:
            return self._core.registry.get(request.name, request.version)
        except InferError as e:
            raise GrpcError(StatusCode.NOT_FOUND, str(e))

    def ModelMetadata(self, request):
        md = self._model(request).metadata()

        def tensors(io):
            return [pb.ModelMetadataResponse.TensorMetadata(
                name=t["name"], datatype=t["datatype"], shape=t["shape"])
                for t in io]

        return pb.ModelMetadataResponse(
            name=md["name"], versions=md["versions"],
            platform=md["platform"], inputs=tensors(md["inputs"]),
            outputs=tensors(md["outputs"]))

    def ModelConfig(self, request):
        return pb.ModelConfigResponse(
            config=self._model(request).config.to_pb())

    def ModelStatistics(self, request):
        try:
            stats = self._core.statistics(request.name or None,
                                          request.version)
        except InferError as e:
            raise GrpcError(StatusCode.NOT_FOUND, str(e))
        resp = pb.ModelStatisticsResponse()
        for s in stats:
            ist = s["inference_stats"]
            resp.model_stats.append(pb.ModelStatistics(
                name=s["name"], version=s["version"],
                last_inference=s["last_inference"],
                inference_count=s["inference_count"],
                execution_count=s["execution_count"],
                inference_stats=pb.InferStatistics(**{
                    key: _statistic(ist[key]["count"], ist[key]["ns"])
                    for key in ("success", "fail", "queue", "compute_input",
                                "compute_infer", "compute_output")})))
        return resp

    # -- the repository ----------------------------------------------------
    def RepositoryIndex(self, request):
        resp = pb.RepositoryIndexResponse()
        for entry in self._core.registry.index(ready_only=request.ready):
            resp.models.append(pb.RepositoryIndexResponse.ModelIndex(
                name=entry["name"], version=entry.get("version", "1"),
                state=entry["state"], reason=entry.get("reason", "")))
        return resp

    def RepositoryModelLoad(self, request):
        config_override, files = None, {}
        for k, v in request.parameters.items():
            which = v.WhichOneof("parameter_choice")
            if k == "config" and which == "string_param":
                config_override = v.string_param
            elif k.startswith("file:") and which == "bytes_param":
                files[k] = base64.b64encode(bytes(v.bytes_param)).decode()
        try:
            self._core.load_model(request.model_name,
                                  config_override=config_override,
                                  files=files or None)
        except InferError as e:
            raise GrpcError(StatusCode.INTERNAL, str(e))
        return pb.RepositoryModelLoadResponse()

    def RepositoryModelUnload(self, request):
        p = request.parameters.get("unload_dependents")
        unload_dependents = bool(
            p is not None and p.WhichOneof("parameter_choice") == "bool_param"
            and p.bool_param)
        try:
            self._core.unload_model(request.model_name, unload_dependents)
        except InferError as e:
            raise GrpcError(StatusCode.INTERNAL, str(e))
        return pb.RepositoryModelUnloadResponse()

    # -- shared memory -----------------------------------------------------
    def SystemSharedMemoryStatus(self, request):
        resp = pb.SystemSharedMemoryStatusResponse()
        for name, r in self._core.system_shm.status(
                request.name or None).items():
            resp.regions[name] = \
                pb.SystemSharedMemoryStatusResponse.RegionStatus(
                    name=r["name"], key=r["key"], offset=r["offset"],
                    byte_size=r["byte_size"])
        return resp

    def SystemSharedMemoryRegister(self, request):
        try:
            self._core.system_shm.register(request.name, request.key,
                                           request.offset, request.byte_size)
        except InferError as e:
            raise GrpcError(StatusCode.INVALID_ARGUMENT, str(e))
        return pb.SystemSharedMemoryRegisterResponse()

    def SystemSharedMemoryUnregister(self, request):
        self._core.system_shm.unregister(request.name or None)
        return pb.SystemSharedMemoryUnregisterResponse()

    def CudaSharedMemoryStatus(self, request):
        resp = pb.CudaSharedMemoryStatusResponse()
        for name, r in self._core.cuda_shm.status(
                request.name or None).items():
            resp.regions[name] = \
                pb.CudaSharedMemoryStatusResponse.RegionStatus(
                    name=r["name"], device_id=r["device_id"],
                    byte_size=r["byte_size"])
        return resp

    def CudaSharedMemoryRegister(self, request):
        try:
            self._core.cuda_shm.register(
                request.name, bytes(request.raw_handle), request.device_id,
                request.byte_size)
        except InferError as e:
            raise GrpcError(StatusCode.INVALID_ARGUMENT, str(e))
        return pb.CudaSharedMemoryRegisterResponse()

    def CudaSharedMemoryUnregister(self, request):
        self._core.cuda_shm.unregister(request.name or None)
        return pb.CudaSharedMemoryUnregisterResponse()

    # -- trace / logging ---------------------------------------------------
    @staticmethod
    def _settings_error(e: InferError) -> GrpcError:
        return GrpcError(StatusCode.UNIMPLEMENTED if e.http_status == 501
                         else StatusCode.INVALID_ARGUMENT, str(e))

    def TraceSetting(self, request):
        core = self._core
        model = request.model_name or ""
        if model:
            try:
                core.registry.get(model)
                update = {k: list(v.value)
                          for k, v in request.settings.items() if v.value}
                cleared = []
                for k, v in request.settings.items():
                    if v.value:
                        continue
                    if k not in TRACE_DEFAULTS:
                        raise InferError(f"unknown trace setting '{k}'", 400)
                    cleared.append(k)
                validate_trace_update(update, model_scope=True)
            except InferError as e:
                raise self._settings_error(e)
            if update or cleared:
                core.tracer.update_model(model, update, cleared)
            settings = core.tracer.effective_settings(model)
        else:
            # an empty value clears the key to its default
            update = {k: list(v.value) if v.value
                      else list(TRACE_DEFAULTS.get(k, []))
                      for k, v in request.settings.items()}
            try:
                validate_trace_update(update)
            except InferError as e:
                raise self._settings_error(e)
            if update:  # an empty map is a read
                core.trace_settings.update(update)
                core.tracer.settings_updated()
            settings = core.trace_settings
        resp = pb.TraceSettingResponse()
        for k, vals in settings.items():
            resp.settings[k] = pb.TraceSettingResponse.SettingValue(
                value=list(vals))
        return resp

    def LogSettings(self, request):
        settings = self._core.log_settings
        for k, v in request.settings.items():
            which = v.WhichOneof("parameter_choice")
            if which:
                settings[k] = getattr(v, which)
        resp = pb.LogSettingsResponse()
        for k, val in settings.items():
            if isinstance(val, bool):
                value = pb.LogSettingsResponse.SettingValue(bool_param=val)
            elif isinstance(val, int):
                value = pb.LogSettingsResponse.SettingValue(uint32_param=val)
            else:
                value = pb.LogSettingsResponse.SettingValue(
                    string_param=str(val))
            resp.settings[k] = value
        return resp

    # -- debug snapshots ---------------------------------------------------
    def FlightRecorder(self, request):
        try:
            limit = parse_snapshot_limit(request.limit or 0)
        except InferError as e:
            raise GrpcError(StatusCode.INVALID_ARGUMENT, str(e))
        return pb_debug.FlightRecorderResponse(payload_json=json.dumps(
            self._core.flight_recorder.snapshot(
                model=request.model_name or None, limit=limit)))

    def DeviceStats(self, request):
        return pb_debug.DeviceStatsResponse(payload_json=json.dumps(
            self._core.device_stats_snapshot(request.model_name or None)))

    def Costs(self, request):
        return pb_debug.CostsResponse(payload_json=json.dumps(
            self._core.cost_ledger.snapshot(
                model=request.model_name or None)))

    # -- inference ---------------------------------------------------------
    def _decode(self, request, wire_bytes: int,
                decode_start_ns: int = 0,
                metadata: Optional[Dict[str, str]] = None) -> InferRequest:
        """The core's request; its decode window (for the request's split)
        from ``decode_start_ns`` (the message's parse) where given; its
        deadline and priority from its parameters, its tenant and trace
        context (``triton-request-id``, ``traceparent``) from the call's
        ``metadata``."""
        start = decode_start_ns or time.monotonic_ns()
        req = decode_request(request)
        req.decode_start_ns, req.decode_end_ns = (start,
                                                  time.monotonic_ns())
        req.protocol = "grpc"
        req.wire_bytes = wire_bytes
        apply_request_deadline(req)
        apply_request_priority(req)
        metadata = metadata or {}
        req.tenant = tenant_from_headers(metadata.get("triton-tenant"),
                                         metadata.get("authorization"))
        # the client's trace context, which the request's trace records
        req.client_request_id = metadata.get("triton-request-id", "")
        req.traceparent = metadata.get("traceparent", "")
        return req

    def _encode(self, resp: InferResponse) -> "pb.ModelInferResponse":
        """The response message, stamped from the core's gRPC templates."""
        return encode_pb_response(
            resp, self._core.grpc_wire_templates,
            self._core.registry.generation(resp.model_name))

    def ModelInfer(self, request, wire_bytes: int = 0,
                   decode_start_ns: int = 0,
                   metadata: Optional[Dict[str, str]] = None):
        try:
            req = self._decode(request, wire_bytes, decode_start_ns,
                               metadata)
            # this servicer finishes the trace: SERIALIZE, NETWORK_WRITE
            req.trace_handoff = True
            resp = self._core.infer(req)
        except InferError as e:
            raise GrpcError.of(e)
        trace = resp.trace
        if trace is None:
            return self._encode(resp)
        try:
            # a stamp encodes the message's parts here, so SERIALIZE covers
            # the encoding too (a message built without a template is
            # encoded by the bridge, after the span)
            t_ser0 = time.monotonic_ns()
            out = self._encode(resp)
            t_ser1 = time.monotonic_ns()
            trace.add_span("SERIALIZE", t_ser0, t_ser1)
            # the bridge writes the message after this returns: the span
            # covers the handoff work still visible from here
            trace.add_span("NETWORK_WRITE", t_ser1, time.monotonic_ns())
        except BaseException as e:
            trace.mark_failed(e)
            raise
        finally:
            trace.emit()
        return out

    def ModelStreamInfer(self, requests: Iterable,
                         metadata: Optional[Dict[str, str]] = None
                         ) -> Iterator["pb.ModelStreamInferResponse"]:
        """Each request's responses in turn, from ``(request, wire bytes)``
        pairs (a request the ingress cap refused is None); a request's
        error travels in-band, prefixed with its HTTP status, and the
        stream goes on.  A decoupled model's empty final response is sent
        only where the request sets ``triton_enable_empty_final_response``
        (the reference's rule, grpc_server.py:584-594)."""
        for request, wire_bytes in requests:
            if request is None:
                yield pb.ModelStreamInferResponse(
                    error_message="[413] " + oversize_message(
                        wire_bytes, self.max_request_bytes))
                continue
            try:
                req = self._decode(request, wire_bytes, metadata=metadata)
                empty_final = bool(req.parameters.get(
                    "triton_enable_empty_final_response", False))
                for resp in self._core.infer_stream(req):
                    if not (resp.outputs or empty_final) and \
                            resp.parameters.get("triton_final_response") \
                            is True:
                        continue
                    t0 = time.monotonic_ns()
                    yield pb.ModelStreamInferResponse(
                        infer_response=self._encode(resp))
                    if resp.trace is not None:
                        resp.trace.record_write(t0, time.monotonic_ns())
            except InferError as e:
                yield pb.ModelStreamInferResponse(
                    error_message=f"[{e.http_status}] {e}")
            except Exception as e:  # noqa: BLE001 - in-band, as reference
                yield pb.ModelStreamInferResponse(error_message=str(e))


# -- the call, on either transport --------------------------------------------
def check_encoding(metadata: Dict[str, str]) -> str:
    """The call's ``grpc-encoding``; UNIMPLEMENTED for one that is not
    identity, gzip or deflate (as grpcio's server answers it)."""
    encoding = metadata.get("grpc-encoding", "identity").strip().lower()
    if encoding not in ("identity", *ENCODINGS):
        raise GrpcError(StatusCode.UNIMPLEMENTED,
                        f"Compression algorithm '{encoding}' is not "
                        "supported")
    return encoding


def request_messages(chunks: Iterable[bytes], encoding: str, cap: int):
    """(message, size) of each data frame of a request body that arrives
    in ``chunks`` (a gRPC-Web client's trailers skipped): a compressed
    frame inflated in ``encoding``; the message None where its size
    passes ``cap`` (it is not decoded, and an uncompressed one is not
    even buffered)."""
    for flags, payload, size in iter_messages(chunks, cap):
        if flags & TRAILER_FLAG:
            continue
        if flags & COMPRESSED_FLAG:
            if encoding not in ENCODINGS:
                raise GrpcError(StatusCode.INTERNAL,
                                "compressed message without a grpc-encoding")
            if payload is not None:
                payload = inflate(payload, encoding, cap)
                size = len(payload)
        yield (None if payload is None or (cap and size > cap)
               else payload), size


def unary_response(servicer: InferenceServicer, method: str, message,
                   metadata: Dict[str, str]) -> Tuple[List, int]:
    """The encoded parts of a unary call's answer to ``message`` (a
    ``request_messages`` item, None where the body held none)."""
    if message is None:
        raise ValueError("missing request message")
    payload, size = message
    if payload is None:
        raise oversize_error(size, servicer.max_request_bytes)
    t0 = time.monotonic_ns()
    request = METHODS[method][1].FromString(payload)
    if method == "ModelInfer":
        resp = servicer.ModelInfer(request, len(payload), t0, metadata)
    else:
        resp = getattr(servicer, method)(request)
    return resp.encode_parts()


def stream_responses(servicer: InferenceServicer, method: str, messages,
                     metadata: Dict[str, str]) -> Iterator[Tuple[List, int]]:
    """The encoded parts of each answer of a stream call, as the requests
    of ``messages`` (``request_messages`` items) are answered in turn."""
    req_type = METHODS[method][1]
    requests = ((None if p is None else req_type.FromString(p), n)
                for p, n in messages)
    for resp in getattr(servicer, method)(requests, metadata):
        yield resp.encode_parts()


def status_of(e: Exception) -> Tuple[StatusCode, str, Dict[str, str]]:
    """A failed call's status, message and trailing metadata."""
    if isinstance(e, GrpcError):
        return e.code, e.message, e.trailing
    return StatusCode.INTERNAL, str(e), {}
