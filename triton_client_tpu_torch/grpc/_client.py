"""Synchronous gRPC ``InferenceServerClient`` of the port.

Counterpart of ``triton_client_tpu/grpc/_client.py``, with the same method
names and signatures, without ``grpcio`` (the machine the port serves on
has none).  The URL is the server's gRPC ``host:port`` (a Triton server's
8001, the port's ``--grpc-port``): the calls go over HTTP/2
(``_h2_transport.py``), every call of the client a stream of one
connection.  Where the peer answers the HTTP/2 preface in HTTP/1.1 (the
port's HTTP port, the reference's bridge), they go as gRPC-Web
(``_transport.py``): unary calls on a pool of kept-alive ``http.client``
connections (the HTTP client's pool), a stream on a socket of its own.
``TC_TPU_GRPC_TRANSPORT=h2|web`` pins the wire (a pinned ``h2`` that the
peer does not speak is an error); the choice is made at the first call.

Beside the HTTP client's surface: ``get_inference_statistics``,
``async_infer`` (a future with ``get_result`` and ``cancel``, or a
``callback(result, error)``), and the stream: ``start_stream``,
``async_stream_infer(..., sequence_id, sequence_start, sequence_end)`` and
``stop_stream``.  Results and statuses are the reference's: the messages
(or with ``as_json=True`` their proto3 JSON), errors as
``InferenceServerException`` with ``status()`` spelled
``"StatusCode.NOT_FOUND"``.

The trace and log settings and the debug snapshots (the flight recorder,
device statistics, costs) are the reference's calls, on the RPCs of the
same names.

Resilience and QoS, as in the reference: ``infer`` and a prepared
request's ``infer`` take ``retry_policy`` (else the client's),
``deadline_s``, ``tenant`` (``triton-tenant`` metadata, a header here) and
``priority``; ``async_infer`` takes ``tenant``, ``retry_policy`` and
``deadline_s`` too.  Each attempt stamps what is left of the deadline as
the v2 ``timeout`` parameter (where the call set none) and caps its
transport timeout with it; a refusal's ``retry-after-ms`` trailer sets the
wait before the next attempt.  Under a client-level policy the health and
metadata calls retry too.

``keepalive_options`` drive the HTTP/2 connection's PINGs, as the
reference's channel options do; of ``channel_args`` only
``grpc.http2.lookahead_bytes`` (each stream's receive window) means
something here: there is no grpcio channel.  The client's deadline travels as
``grpc-timeout`` over HTTP/2.  The repository calls (``get_model_repository_index``, ``load_model`` with
``config`` and ``files``, ``unload_model`` with ``unload_dependents``) are
the reference's.

Telemetry, as in the HTTP client: each call of ``infer``, a prepared
request's ``infer``, ``async_infer`` and ``infer_many`` stamps
``traceparent`` and ``triton-request-id`` (headers here, metadata in
gRPC), is counted in the client registry and, where client tracing is on,
records its spans; a stream carries one trace context, and each request
sent on it is counted without a latency.  ``infer_many`` is the HTTP
client's, over ModelInfer.  ``start_stream(stream_timeout=S)`` is the
stream's deadline: each read of its socket waits at most until S seconds
after the start, and then the callback gets DEADLINE_EXCEEDED and the
stream ends.

TLS, as in the reference: ``ssl=True`` with ``root_certificates`` (the CA
file that verifies the server; the system's CAs without it),
``private_key`` and ``certificate_chain`` (the client's own pair), paths
as the reference takes them.  ``creds`` cannot be a
``grpc.ChannelCredentials`` (the card's machine has no grpcio): it is an
``ssl.SSLContext``, used as is (ALPN ``h2`` and ``http/1.1`` offered on
it).  Both apply to either wire.  ``compression_algorithm`` ``gzip`` or ``deflate``
compresses the request frames (flag bit 0x01, ``grpc-encoding``) of a
unary call or of a stream; answers come back uncompressed.
"""

from __future__ import annotations

import json
import ssl as _ssl
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeoutError
from typing import Callable, Dict, List, Optional

from .._client import InferenceServerClientBase
from .._request import Request
from .._resilience import (call_with_retry, deadline_exceeded_error,
                           min_timeout, remaining_us)
from .._telemetry import merge_trace_headers, telemetry, traceparent_on_wire
from ..http._client import _ConnectionPool
from ..protocol import debug as pb_debug
from ..protocol import inference as pb
from ..protocol._proto3 import to_dict
from ..protocol.grpc_web import ENCODINGS, compress_frame, encode_frame
from ..utils import InferenceServerException, raise_error
from ._infer_result import InferResult
from ._infer_stream import _InferStream
from ._h2_transport import select_transport
from ._template import RequestTemplate
from ._transport import RpcError
from ._utils import get_inference_request, raise_error_grpc

#: kept-alive connections held for unary calls, and threads of async_infer
_POOL_SIZE = 16


def _maybe_json(message, as_json: bool):
    return to_dict(message) if as_json else message


def grpc_encoding(compression_algorithm) -> Optional[str]:
    """The request frames' ``grpc-encoding`` of the reference's
    ``compression_algorithm`` (None: uncompressed)."""
    if compression_algorithm is None or compression_algorithm == "none":
        return None
    if compression_algorithm in ENCODINGS:
        return compression_algorithm
    raise_error(f"unsupported compression algorithm "
                f"{compression_algorithm!r}")


def compressed(frame: bytes, headers: dict,
               encoding: Optional[str]) -> bytes:
    """``frame`` in ``encoding``, its ``grpc-encoding`` header set in
    ``headers``; as it is without an encoding."""
    if encoding is None:
        return frame
    headers["grpc-encoding"] = encoding
    return compress_frame(frame, encoding)


def channel_ssl_context(ssl: bool, root_certificates=None,
                        private_key=None, certificate_chain=None,
                        creds=None) -> Optional[_ssl.SSLContext]:
    """The client's TLS context: ``creds`` (an ``ssl.SSLContext``) as is;
    under ``ssl`` the server verified against ``root_certificates`` (else
    the system's CAs) and the client's pair loaded where given; None for
    plain HTTP."""
    if creds is not None:
        if not isinstance(creds, _ssl.SSLContext):
            raise_error("creds must be an ssl.SSLContext (there are no "
                        f"grpc.ChannelCredentials here), got "
                        f"{type(creds).__name__}")
        return creds
    if not ssl:
        return None
    ctx = _ssl.create_default_context(cafile=root_certificates)
    if certificate_chain:
        ctx.load_cert_chain(certificate_chain, private_key)
    return ctx


#: the RPCs a client-level policy retries, by their retry class
_IDEMPOTENT = {"ServerLive": "health", "ServerReady": "health",
               "ModelReady": "health", "ServerMetadata": "metadata",
               "ModelMetadata": "metadata", "ModelConfig": "metadata"}


class KeepAliveOptions:
    """The reference's gRPC keepalive options: the HTTP/2 connection's
    PINGs (``_h2_transport.py``); nothing on gRPC-Web."""

    def __init__(self, keepalive_time_ms: int = 2 ** 31 - 1,
                 keepalive_timeout_ms: int = 20000,
                 keepalive_permit_without_calls: bool = False,
                 http2_max_pings_without_data: int = 2):
        self.keepalive_time_ms = keepalive_time_ms
        self.keepalive_timeout_ms = keepalive_timeout_ms
        self.keepalive_permit_without_calls = keepalive_permit_without_calls
        self.http2_max_pings_without_data = http2_max_pings_without_data


class CallContext:
    """Cancellation handle of an ``async_infer`` with a callback."""

    def __init__(self, future: Future):
        self._future = future

    def cancel(self) -> bool:
        return self._future.cancel()


class InferAsyncRequest:
    """Handle of an in-flight ``async_infer``."""

    def __init__(self, future: Future):
        self._future = future

    def get_result(self, block: bool = True,
                   timeout: Optional[float] = None) -> InferResult:
        """The InferResult, once the response is in (waiting by default);
        raises InferenceServerException on an error, with status
        ``StatusCode.DEADLINE_EXCEEDED`` on a timeout."""
        try:
            return self._future.result(timeout=timeout if block else 0)
        except (TimeoutError, FuturesTimeoutError):
            raise InferenceServerException(
                msg="timed out waiting for inference response",
                status="StatusCode.DEADLINE_EXCEEDED") from None

    def cancel(self) -> bool:
        return self._future.cancel()


class PreparedRequest:
    """A compiled :class:`RequestTemplate` bound to a client (the wire fast
    path): ``infer()`` and ``async_stream_infer()`` stamp only the request
    id and the tensors' bytes; change the data with ``set_data_from_numpy``
    on the ``InferInput`` objects given to ``prepare()``.  One handle per
    thread."""

    def __init__(self, client: "InferenceServerClient",
                 template: RequestTemplate):
        self._client = client
        self.template = template

    def infer(self, request_id="", headers=None, tenant=None,
              client_timeout=None, retry_policy=None,
              deadline_s: Optional[float] = None) -> InferResult:
        """Fast-path inference, with ``client.infer``'s contract (a retry
        stamps the remaining deadline anew, where the template holds no
        ``timeout`` of its own)."""
        template = self.template
        return self._client._with_policy(
            retry_policy, deadline_s, template.model_name, request_id,
            "infer", lambda remaining: self._client._infer_prepared(
                self, request_id, headers, tenant, client_timeout,
                remaining))

    def async_stream_infer(self, request_id="") -> None:
        """Send the request on the client's stream (``start_stream``); its
        answer reaches the stream's callback."""
        frame = self.template.stamp(request_id)
        self._client._stream_send(frame)
        telemetry().record_request(
            self.template.model_name, "grpc", "stream_infer", None, ok=True,
            request_bytes=len(frame) - 5, request_id=request_id)


class InferenceServerClient(InferenceServerClientBase):
    """Client of the v2 protocol over gRPC (HTTP/2, or gRPC-Web).
    Thread-safe, except the stream: one at a time per client."""

    def __init__(self, url: str, verbose: bool = False, ssl: bool = False,
                 root_certificates: Optional[str] = None,
                 private_key: Optional[str] = None,
                 certificate_chain: Optional[str] = None, creds=None,
                 keepalive_options: Optional[KeepAliveOptions] = None,
                 channel_args: Optional[List[tuple]] = None,
                 retry_policy=None):
        super().__init__()
        if "://" in url:
            raise_error("url should not include the scheme")
        self._url = url
        self._verbose = verbose
        self._ssl_context = channel_ssl_context(
            ssl, root_certificates, private_key, certificate_chain, creds)
        self._keepalive = keepalive_options
        self._channel_args = channel_args
        # HTTP/2 or gRPC-Web, chosen at the first call
        self._wire = None
        self._wire_lock = threading.Lock()
        self._stream: Optional[_InferStream] = None
        self._executor: Optional[ThreadPoolExecutor] = None
        self._lock = threading.Lock()
        # the client's default policy: health and metadata calls retry
        # under it, infer where it opts in (a call's retry_policy wins)
        self._retry_policy = retry_policy

    @property
    def url(self) -> str:
        return self._url

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """Stop the stream, wait for async requests and close every pooled
        connection."""
        self.stop_stream()
        with self._lock:
            executor, self._executor = self._executor, None
        if executor is not None:
            executor.shutdown(wait=True)
        with self._wire_lock:
            wire, self._wire = self._wire, None
        if wire is not None:
            wire.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass

    # -- transport ---------------------------------------------------------
    def _transport(self):
        """The client's wire (RpcError where the server cannot be reached:
        the next call tries again)."""
        with self._wire_lock:
            if self._wire is None:
                self._wire = select_transport(
                    self._url, lambda: _ConnectionPool(
                        self._url, _POOL_SIZE, 60.0, None,
                        self._ssl_context),
                    self._ssl_context, self._keepalive,
                    channel_args=self._channel_args)
            return self._wire

    def _headers(self, headers: Optional[dict]) -> dict:
        request = Request(dict(headers) if headers else {})
        self._call_plugin(request)
        return request.headers

    def _call(self, method: str, request, response_type, headers,
              client_timeout=None):
        if self._verbose:
            print(f"{method}, headers {headers}\n{request}")
        frame = encode_frame(request)
        kind = _IDEMPOTENT.get(method)
        if self._retry_policy is None or kind is None:
            return self._unary(method, frame, response_type, headers,
                               client_timeout)
        return call_with_retry(
            self._retry_policy,
            lambda remaining, _attempt: self._unary(
                method, frame, response_type, headers,
                min_timeout(client_timeout, remaining)),
            method=kind, retry_meta=("", "grpc", kind, ""))

    def _with_policy(self, retry_policy, deadline_s, model_name: str,
                     request_id: str, method_name: str, attempt):
        """``attempt(remaining_s)`` under the call's policy (else the
        client's) and deadline; a single attempt without either."""
        policy = retry_policy if retry_policy is not None \
            else self._retry_policy
        if policy is None and deadline_s is None:
            return attempt(None)
        return call_with_retry(
            policy, lambda remaining, _attempt: attempt(remaining),
            method="infer", deadline_s=deadline_s,
            retry_meta=(model_name, "grpc", method_name, request_id),
            journey=True)

    def _unary(self, method: str, frame: bytes, response_type, headers,
               client_timeout, sizes: Optional[list] = None):
        """One unary call of an encoded request frame: its response, or
        InferenceServerException with the call's status."""
        try:
            response = self._transport().unary(
                method, frame, response_type, self._headers(headers),
                client_timeout, sizes)
        except RpcError as e:
            raise_error_grpc(e)
        if self._verbose:
            print(response)
        return response

    # -- health / metadata -------------------------------------------------
    def is_server_live(self, headers=None, client_timeout=None) -> bool:
        return self._call("ServerLive", pb.ServerLiveRequest(),
                          pb.ServerLiveResponse, headers,
                          client_timeout).live

    def is_server_ready(self, headers=None, client_timeout=None) -> bool:
        return self._call("ServerReady", pb.ServerReadyRequest(),
                          pb.ServerReadyResponse, headers,
                          client_timeout).ready

    def is_model_ready(self, model_name, model_version="", headers=None,
                       client_timeout=None) -> bool:
        return self._call("ModelReady", pb.ModelReadyRequest(
            name=model_name, version=model_version), pb.ModelReadyResponse,
            headers, client_timeout).ready

    def get_server_metadata(self, headers=None, as_json=False,
                            client_timeout=None):
        return _maybe_json(self._call(
            "ServerMetadata", pb.ServerMetadataRequest(),
            pb.ServerMetadataResponse, headers, client_timeout), as_json)

    def get_model_metadata(self, model_name, model_version="", headers=None,
                           as_json=False, client_timeout=None):
        return _maybe_json(self._call(
            "ModelMetadata", pb.ModelMetadataRequest(
                name=model_name, version=model_version),
            pb.ModelMetadataResponse, headers, client_timeout), as_json)

    def get_model_config(self, model_name, model_version="", headers=None,
                         as_json=False, client_timeout=None):
        return _maybe_json(self._call(
            "ModelConfig", pb.ModelConfigRequest(
                name=model_name, version=model_version),
            pb.ModelConfigResponse, headers, client_timeout), as_json)

    def get_inference_statistics(self, model_name="", model_version="",
                                 headers=None, as_json=False,
                                 client_timeout=None):
        return _maybe_json(self._call(
            "ModelStatistics", pb.ModelStatisticsRequest(
                name=model_name, version=model_version),
            pb.ModelStatisticsResponse, headers, client_timeout), as_json)

    # -- trace and log settings, debug snapshots ---------------------------
    def update_trace_settings(self, model_name=None, settings=None,
                              headers=None, as_json=False,
                              client_timeout=None):
        """Set the server's trace settings (a model's where
        ``model_name``); a ``None`` value clears a key.  Returns the
        settings now in force."""
        request = pb.TraceSettingRequest(model_name=model_name or "")
        for key, value in (settings or {}).items():
            vals = ([] if value is None else value if isinstance(value, list)
                    else [str(value)])
            request.settings[key] = pb.TraceSettingRequest.SettingValue(
                value=vals)
        return _maybe_json(self._call(
            "TraceSetting", request, pb.TraceSettingResponse, headers,
            client_timeout), as_json)

    def get_trace_settings(self, model_name=None, headers=None,
                           as_json=False, client_timeout=None):
        return self.update_trace_settings(model_name, None, headers, as_json,
                                          client_timeout)

    def update_log_settings(self, settings, headers=None, as_json=False,
                            client_timeout=None):
        request = pb.LogSettingsRequest()
        for key, value in settings.items():
            if isinstance(value, bool):
                entry = pb.LogSettingsRequest.SettingValue(bool_param=value)
            elif isinstance(value, int):
                entry = pb.LogSettingsRequest.SettingValue(
                    uint32_param=value)
            else:
                entry = pb.LogSettingsRequest.SettingValue(
                    string_param=str(value))
            request.settings[key] = entry
        return _maybe_json(self._call(
            "LogSettings", request, pb.LogSettingsResponse, headers,
            client_timeout), as_json)

    def get_log_settings(self, headers=None, as_json=False,
                         client_timeout=None):
        return self.update_log_settings({}, headers, as_json, client_timeout)

    def get_flight_recorder(self, model_name=None, limit=0, headers=None,
                            client_timeout=None) -> dict:
        """The flight recorder's snapshot (the HTTP route's JSON)."""
        return json.loads(self._call(
            "FlightRecorder", pb_debug.FlightRecorderRequest(
                model_name=model_name or "", limit=int(limit or 0)),
            pb_debug.FlightRecorderResponse, headers,
            client_timeout).payload_json)

    def get_device_stats(self, model_name=None, headers=None,
                         client_timeout=None) -> dict:
        """The device statistics (the HTTP route's JSON)."""
        return json.loads(self._call(
            "DeviceStats", pb_debug.DeviceStatsRequest(
                model_name=model_name or ""),
            pb_debug.DeviceStatsResponse, headers,
            client_timeout).payload_json)

    def get_costs(self, model_name=None, headers=None,
                  client_timeout=None) -> dict:
        """The cost ledger (the HTTP route's JSON)."""
        return json.loads(self._call(
            "Costs", pb_debug.CostsRequest(model_name=model_name or ""),
            pb_debug.CostsResponse, headers, client_timeout).payload_json)

    # -- the repository ----------------------------------------------------
    def get_model_repository_index(self, headers=None, as_json=False,
                                   client_timeout=None):
        return _maybe_json(self._call(
            "RepositoryIndex", pb.RepositoryIndexRequest(),
            pb.RepositoryIndexResponse, headers, client_timeout), as_json)

    def load_model(self, model_name, headers=None,
                   config: Optional[str] = None, files=None,
                   client_timeout=None) -> None:
        request = pb.RepositoryModelLoadRequest(model_name=model_name)
        if config is not None:
            request.parameters["config"] = pb.ModelRepositoryParameter(
                string_param=config)
        for path, content in (files or {}).items():
            request.parameters[path] = pb.ModelRepositoryParameter(
                bytes_param=content)
        self._call("RepositoryModelLoad", request,
                   pb.RepositoryModelLoadResponse, headers, client_timeout)

    def unload_model(self, model_name, headers=None, unload_dependents=False,
                     client_timeout=None) -> None:
        request = pb.RepositoryModelUnloadRequest(model_name=model_name)
        request.parameters["unload_dependents"] = \
            pb.ModelRepositoryParameter(bool_param=unload_dependents)
        self._call("RepositoryModelUnload", request,
                   pb.RepositoryModelUnloadResponse, headers, client_timeout)

    # -- shared memory -----------------------------------------------------
    def get_system_shared_memory_status(self, region_name="", headers=None,
                                        as_json=False, client_timeout=None):
        return _maybe_json(self._call(
            "SystemSharedMemoryStatus",
            pb.SystemSharedMemoryStatusRequest(name=region_name),
            pb.SystemSharedMemoryStatusResponse, headers, client_timeout),
            as_json)

    def register_system_shared_memory(self, name, key, byte_size, offset=0,
                                      headers=None,
                                      client_timeout=None) -> None:
        self._call("SystemSharedMemoryRegister",
                   pb.SystemSharedMemoryRegisterRequest(
                       name=name, key=key, offset=offset,
                       byte_size=byte_size),
                   pb.SystemSharedMemoryRegisterResponse, headers,
                   client_timeout)
        telemetry().record_shm_register("grpc", "system", byte_size)

    def unregister_system_shared_memory(self, name="", headers=None,
                                        client_timeout=None) -> None:
        self._call("SystemSharedMemoryUnregister",
                   pb.SystemSharedMemoryUnregisterRequest(name=name),
                   pb.SystemSharedMemoryUnregisterResponse, headers,
                   client_timeout)

    def get_cuda_shared_memory_status(self, region_name="", headers=None,
                                      as_json=False, client_timeout=None):
        return _maybe_json(self._call(
            "CudaSharedMemoryStatus",
            pb.CudaSharedMemoryStatusRequest(name=region_name),
            pb.CudaSharedMemoryStatusResponse, headers, client_timeout),
            as_json)

    def register_cuda_shared_memory(self, name, raw_handle: bytes,
                                    device_id: int, byte_size: int,
                                    headers=None,
                                    client_timeout=None) -> None:
        """Register a CUDA region; ``raw_handle`` is
        ``cuda_shared_memory.get_raw_handle``'s."""
        self._call("CudaSharedMemoryRegister",
                   pb.CudaSharedMemoryRegisterRequest(
                       name=name, raw_handle=raw_handle,
                       device_id=device_id, byte_size=byte_size),
                   pb.CudaSharedMemoryRegisterResponse, headers,
                   client_timeout)
        telemetry().record_shm_register("grpc", "cuda", byte_size)

    def unregister_cuda_shared_memory(self, name="", headers=None,
                                      client_timeout=None) -> None:
        self._call("CudaSharedMemoryUnregister",
                   pb.CudaSharedMemoryUnregisterRequest(name=name),
                   pb.CudaSharedMemoryUnregisterResponse, headers,
                   client_timeout)

    # -- inference ---------------------------------------------------------
    def _send_infer(self, frame: bytes, headers, client_timeout,
                    tenant: Optional[str], model_name: str, method: str,
                    request_id: str, t_ser0: int,
                    sink: Optional[list] = None,
                    encoding: Optional[str] = None) -> InferResult:
        """One ModelInfer call of an encoded request frame: ``tenant`` in
        the ``triton-tenant`` metadata, the trace headers, the frame
        compressed in ``encoding`` where given; counted in the client
        registry (or, with ``sink``, its outcome appended there for the
        caller's one count of a flight) and, where tracing is on, its spans
        recorded (``t_ser0``: when the request's build began)."""
        user = dict(headers or {})
        trace_headers, rid = merge_trace_headers(user, request_id)
        sent: Dict[str, str] = {**user, **trace_headers}
        if tenant:
            sent["triton-tenant"] = str(tenant)
        tel = telemetry()
        req_bytes = len(frame) - 5  # less the gRPC-Web frame header
        frame = compressed(frame, sent, encoding)
        t_ser1 = time.monotonic_ns()
        sizes: list = []
        t0 = time.perf_counter()
        try:
            response = self._unary("ModelInfer", frame,
                                   pb.ModelInferResponse, sent,
                                   client_timeout, sizes)
        except InferenceServerException:
            latency = time.perf_counter() - t0
            if sink is not None:
                sink.append((False, latency, req_bytes, 0, rid))
            else:
                tel.record_request(model_name, "grpc", method, latency,
                                   ok=False, request_bytes=req_bytes,
                                   request_id=rid)
                if tel.tracing_enabled:
                    tel.record_infer_spans(
                        rid, model_name, "grpc", method, t_ser0, t_ser1,
                        time.monotonic_ns(),
                        traceparent=traceparent_on_wire(user, trace_headers),
                        ok=False)
            raise
        t_net1 = time.monotonic_ns()
        outcome = (True, time.perf_counter() - t0, req_bytes, sizes[0], rid)
        if sink is not None:
            sink.append(outcome)
        else:
            tel.record_request(model_name, "grpc", method, outcome[1],
                               ok=True, request_bytes=req_bytes,
                               response_bytes=outcome[3], request_id=rid)
        result = InferResult(response)
        if tel.tracing_enabled:
            tel.record_infer_spans(
                rid, model_name, "grpc", method, t_ser0, t_ser1, t_net1,
                traceparent=traceparent_on_wire(user, trace_headers))
        return result

    def _infer_attempt(self, model_name, inputs, model_version, outputs,
                       request_id, sequence_id, sequence_start, sequence_end,
                       priority, timeout, client_timeout, headers,
                       parameters, tenant, remaining, encoding=None):
        """One attempt: what is left of the deadline as the ``timeout``
        parameter (where the call set none) and the transport timeout."""
        t_ser0 = time.monotonic_ns()
        if timeout is None and remaining is not None:
            timeout = remaining_us(remaining)
        request = get_inference_request(
            model_name, inputs, model_version, request_id, outputs,
            sequence_id, sequence_start, sequence_end, priority, timeout,
            parameters)
        if self._verbose:
            print(f"infer\n{request}")
        return self._send_infer(encode_frame(request), headers,
                                min_timeout(client_timeout, remaining),
                                tenant, model_name, "infer", request_id,
                                t_ser0, encoding=encoding)

    def _infer_prepared(self, prep: PreparedRequest, request_id, headers,
                        tenant, client_timeout, remaining, raws=None,
                        sink=None) -> InferResult:
        """One attempt of a prepared request (the remaining deadline as the
        ``timeout`` parameter, where the template holds none), of the
        bound inputs' data or of ``raws``."""
        t_ser0 = time.monotonic_ns()
        template = prep.template
        timeout_us = None
        if remaining is not None and "timeout" not in template._params:
            timeout_us = remaining_us(remaining)
        return self._send_infer(
            template.stamp(request_id, timeout_us, raws), headers,
            min_timeout(client_timeout, remaining), tenant,
            template.model_name, "infer", request_id, t_ser0, sink)

    def infer_many(self, model_name, requests, model_version="",
                   outputs=None, priority=0, timeout=None, parameters=None,
                   request_ids=None, headers=None,
                   tenant: Optional[str] = None, client_timeout=None,
                   retry_policy=None,
                   deadline_s: Optional[float] = None) -> List[InferResult]:
        """Send every item of ``requests`` (each a list of ``InferInput``
        with data, of the first item's names, datatypes and shapes) through
        one compiled template, one after another, under one retry and
        deadline envelope: the results, in order, equal N ``infer`` calls.
        The client registry counts each request, under one lock per
        flight; a retry resumes at the request that failed, and one
        deadline covers the whole flight."""
        items = list(requests)
        if not items:
            return []
        template = RequestTemplate(model_name, items[0], outputs,
                                   model_version, priority, timeout,
                                   parameters)
        prep = PreparedRequest(self, template)
        payloads = [template.raws_for(item) for item in items]
        ids = list(request_ids) if request_ids else [""] * len(items)
        if len(ids) != len(items):
            raise_error("request_ids length must match requests")
        results: List[Optional[InferResult]] = [None] * len(items)
        done = [0]  # the requests answered, across attempts

        def flight(remaining, _attempt):
            deadline = (time.monotonic() + remaining
                        if remaining is not None else None)
            sink: list = []
            try:
                while done[0] < len(items):
                    i = done[0]
                    left = None
                    if deadline is not None:
                        left = deadline - time.monotonic()
                        if left <= 0:
                            raise deadline_exceeded_error()
                    results[i] = self._infer_prepared(
                        prep, ids[i], headers, tenant, client_timeout, left,
                        raws=payloads[i], sink=sink)
                    done[0] += 1
            finally:
                telemetry().record_request_batch(model_name, "grpc",
                                                 "infer", sink)
            return results

        policy = retry_policy if retry_policy is not None \
            else self._retry_policy
        if policy is None and deadline_s is None:
            return flight(None, 1)
        return call_with_retry(policy, flight, method="infer",
                               deadline_s=deadline_s,
                               retry_meta=(model_name, "grpc", "infer", ""))

    def infer(self, model_name, inputs, model_version="", outputs=None,
              request_id="", sequence_id=0, sequence_start=False,
              sequence_end=False, priority=0, timeout=None,
              client_timeout=None, headers=None, compression_algorithm=None,
              parameters=None, retry_policy=None,
              deadline_s: Optional[float] = None,
              tenant: Optional[str] = None) -> InferResult:
        """Run one inference and wait for its result.  ``retry_policy``
        (else the client's) retries retryable failures where it opts in to
        ``retry_infer``; ``deadline_s`` caps the time across attempts and
        travels to the server as the ``timeout`` parameter; ``priority``
        and ``tenant`` are the QoS identity, sent on every attempt."""
        encoding = grpc_encoding(compression_algorithm)
        return self._with_policy(
            retry_policy, deadline_s, model_name, request_id, "infer",
            lambda remaining: self._infer_attempt(
                model_name, inputs, model_version, outputs, request_id,
                sequence_id, sequence_start, sequence_end, priority,
                timeout, client_timeout, headers, parameters, tenant,
                remaining, encoding))

    def prepare(self, model_name, inputs, model_version="", outputs=None,
                priority=0, timeout=None, parameters=None) -> PreparedRequest:
        """Compile the fixed part of a request once (``_template.py``); the
        handle's calls stamp only the id and the tensors' bytes.  ``inputs``
        must carry their data (or a region) already."""
        return PreparedRequest(self, RequestTemplate(
            model_name, inputs, outputs, model_version, priority, timeout,
            parameters))

    def async_infer(self, model_name, inputs, callback: Optional[
            Callable] = None, model_version="", outputs=None, request_id="",
            sequence_id=0, sequence_start=False, sequence_end=False,
            priority=0, timeout=None, client_timeout=None, headers=None,
            compression_algorithm=None, parameters=None, tenant=None,
            retry_policy=None, deadline_s: Optional[float] = None):
        """Send an inference from the client's pool of threads.  With a
        ``callback``, it is called as ``callback(result, error)`` and a
        :class:`CallContext` returned; else an :class:`InferAsyncRequest`
        whose ``get_result()`` waits.  The request is encoded before this
        returns, so the inputs may change afterwards; retries and the
        deadline, as ``infer``'s, run on the pool's thread (each attempt
        encoded anew with the remaining deadline)."""
        encoding = grpc_encoding(compression_algorithm)
        request = get_inference_request(
            model_name, inputs, model_version, request_id, outputs,
            sequence_id, sequence_start, sequence_end, priority, timeout,
            parameters)
        frame = encode_frame(request)
        policy = retry_policy if retry_policy is not None \
            else self._retry_policy

        def attempt(remaining):
            t_ser0 = time.monotonic_ns()
            if remaining is None or timeout is not None:
                return self._send_infer(frame, headers, client_timeout,
                                        tenant, model_name, "async_infer",
                                        request_id, t_ser0,
                                        encoding=encoding)
            request.parameters["timeout"] = pb.InferParameter(
                int64_param=remaining_us(remaining))
            return self._send_infer(encode_frame(request), headers,
                                    min_timeout(client_timeout, remaining),
                                    tenant, model_name, "async_infer",
                                    request_id, t_ser0, encoding=encoding)

        if policy is not None or deadline_s is not None:
            # later attempts encode the request anew: it must not see the
            # caller's arrays change
            raws = [bytes(r) for r in request.raw_input_contents]
            del request.raw_input_contents[:]
            request.raw_input_contents.extend(raws)

        def send():
            return self._with_policy(retry_policy, deadline_s, model_name,
                                     request_id, "async_infer", attempt)

        def call():
            if callback is None:
                return send()
            try:
                result = send()
            except InferenceServerException as e:
                callback(result=None, error=e)
            else:
                callback(result=result, error=None)

        with self._lock:
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=_POOL_SIZE,
                    thread_name_prefix="tc-torch-grpc")
            future = self._executor.submit(call)
        if callback is None:
            return InferAsyncRequest(future)

        def cancelled(f: Future) -> None:
            if f.cancelled():
                callback(result=None, error=InferenceServerException(
                    msg="Locally cancelled by application!",
                    status="StatusCode.CANCELLED"))

        future.add_done_callback(cancelled)
        return CallContext(future)

    # -- streaming ---------------------------------------------------------
    def start_stream(self, callback, stream_timeout=None, headers=None,
                     compression_algorithm=None) -> None:
        """Open the stream; ``callback(result, error)`` runs on its reader
        thread for every answer, in order."""
        encoding = grpc_encoding(compression_algorithm)
        if self._stream is not None:
            raise_error(
                "cannot start another stream with one already running. "
                "'InferenceServerClient' supports only a single active "
                "stream at a given time.")
        # one trace context for the stream: its requests share it
        sent = self._headers(headers)
        sent.update(merge_trace_headers(sent)[0])
        try:
            self._stream = _InferStream(self._transport(), callback, sent,
                                        self._verbose, stream_timeout,
                                        encoding)
        except RpcError as e:
            raise_error_grpc(e)

    def _stream_send(self, frame: bytes) -> None:
        if self._stream is None:
            raise_error("stream not available, start_stream() must be "
                        "called first.")
        try:
            self._stream.send(frame)
        except RpcError as e:
            raise_error_grpc(e)

    def async_stream_infer(self, model_name, inputs, model_version="",
                           outputs=None, request_id="", sequence_id=0,
                           sequence_start=False, sequence_end=False,
                           enable_empty_final_response=False, priority=0,
                           timeout=None, parameters=None) -> None:
        """Send a request on the stream; its answer reaches the stream's
        callback.  The request is encoded and sent before this returns."""
        request = get_inference_request(
            model_name, inputs, model_version, request_id, outputs,
            sequence_id, sequence_start, sequence_end, priority, timeout,
            parameters)
        if enable_empty_final_response:
            request.parameters["triton_enable_empty_final_response"] = \
                pb.InferParameter(bool_param=True)
        if self._verbose:
            print(f"async_stream_infer\n{request}")
        frame = encode_frame(request)
        self._stream_send(frame)
        # counted when sent, without a latency: the answer comes on the
        # stream's callback
        telemetry().record_request(
            model_name, "grpc", "stream_infer", None, ok=True,
            request_bytes=len(frame) - 5, request_id=request_id)

    def stop_stream(self, cancel_requests: bool = False) -> None:
        """Close the stream: after the server has answered every request
        sent, or at once with ``cancel_requests``."""
        stream, self._stream = self._stream, None
        if stream is not None:
            stream.close(cancel_requests)

