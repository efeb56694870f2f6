"""Synchronous gRPC ``InferenceServerClient`` of the port.

Counterpart of ``triton_client_tpu/grpc/_client.py``, with the same method
names and signatures, over gRPC-Web on HTTP/1.1 (``_transport.py``): the
machine the port serves on has no ``grpcio``, and the port's server serves
gRPC on its HTTP port.  So the URL is the server's HTTP ``host:port``.
Unary calls share a pool of kept-alive ``http.client`` connections (the
HTTP client's pool); a stream has a socket of its own.

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

``keepalive_options`` and ``channel_args`` are taken and mean nothing:
they set HTTP/2 channel options, and these calls run on HTTP/1.1.  Not
ported yet, and raising with their ROADMAP item: TLS and compression
(A3b); the repository calls (A3b); ``infer_many`` and ``stream_timeout``
(A6b).
"""

from __future__ import annotations

import json
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeoutError
from typing import Callable, List, Optional

from .._client import InferenceServerClientBase
from .._request import Request
from .._resilience import call_with_retry, min_timeout, remaining_us
from ..http._client import _ConnectionPool, _not_ported
from ..protocol import debug as pb_debug
from ..protocol import inference as pb
from ..protocol._proto3 import to_dict
from ..protocol.grpc_web import encode_frame
from ..utils import InferenceServerException, raise_error
from ._infer_result import InferResult
from ._infer_stream import _InferStream
from ._template import RequestTemplate
from ._transport import RpcError, unary
from ._utils import get_inference_request, raise_error_grpc

#: kept-alive connections held for unary calls, and threads of async_infer
_POOL_SIZE = 16


def _maybe_json(message, as_json: bool):
    return to_dict(message) if as_json else message


def _check_unported(compression_algorithm=None) -> None:
    if compression_algorithm not in (None, "none"):
        _not_ported("gRPC compression", "A3b")


#: the RPCs a client-level policy retries, by their retry class
_IDEMPOTENT = {"ServerLive": "health", "ServerReady": "health",
               "ModelReady": "health", "ServerMetadata": "metadata",
               "ModelMetadata": "metadata", "ModelConfig": "metadata"}


class KeepAliveOptions:
    """The reference's gRPC keepalive options.  Taken, and they mean
    nothing here: they tune HTTP/2 pings, and these calls run on
    HTTP/1.1 connections."""

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

        def attempt(remaining):
            timeout_us = None
            if remaining is not None and "timeout" not in template._params:
                timeout_us = remaining_us(remaining)
            return self._client._send_infer(
                template.stamp(request_id, timeout_us), headers,
                min_timeout(client_timeout, remaining), tenant)

        return self._client._with_policy(
            retry_policy, deadline_s, template.model_name, request_id,
            "infer", attempt)

    def async_stream_infer(self, request_id="") -> None:
        """Send the request on the client's stream (``start_stream``); its
        answer reaches the stream's callback."""
        self._client._stream_send(self.template.stamp(request_id))


class InferenceServerClient(InferenceServerClientBase):
    """Client of the v2 protocol over gRPC(-Web).  Thread-safe, except the
    stream: one at a time per client."""

    def __init__(self, url: str, verbose: bool = False, ssl: bool = False,
                 root_certificates: Optional[str] = None,
                 private_key: Optional[str] = None,
                 certificate_chain: Optional[str] = None, creds=None,
                 keepalive_options: Optional[KeepAliveOptions] = None,
                 channel_args: Optional[List[tuple]] = None,
                 retry_policy=None):
        super().__init__()
        if ssl or creds is not None:
            _not_ported("TLS (ssl=True, creds)", "A3b")
        if "://" in url:
            raise_error("url should not include the scheme")
        self._url = url
        self._verbose = verbose
        # the stream's socket is opened per stream
        self._pool = _ConnectionPool(url, _POOL_SIZE, 60.0, None)
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
        self._pool.clear()

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
            retry_meta=(model_name, "grpc", method_name, request_id))

    def _unary(self, method: str, frame: bytes, response_type, headers,
               client_timeout):
        """One unary call of an encoded request frame: its response, or
        InferenceServerException with the call's status."""
        try:
            response = unary(self._pool, method, frame, response_type,
                             self._headers(headers), client_timeout)
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

    # -- not ported --------------------------------------------------------
    def get_model_repository_index(self, *args, **kwargs):
        _not_ported("get_model_repository_index (the repository API)", "A3b")

    def load_model(self, *args, **kwargs):
        _not_ported("load_model (the repository API)", "A3b")

    def unload_model(self, *args, **kwargs):
        _not_ported("unload_model (the repository API)", "A3b")

    def infer_many(self, *args, **kwargs):
        _not_ported("infer_many", "A6b")

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

    def unregister_cuda_shared_memory(self, name="", headers=None,
                                      client_timeout=None) -> None:
        self._call("CudaSharedMemoryUnregister",
                   pb.CudaSharedMemoryUnregisterRequest(name=name),
                   pb.CudaSharedMemoryUnregisterResponse, headers,
                   client_timeout)

    # -- inference ---------------------------------------------------------
    def _send_infer(self, frame: bytes, headers, client_timeout,
                    tenant: Optional[str] = None):
        """One ModelInfer call with an encoded request frame; ``tenant`` in
        the ``triton-tenant`` metadata."""
        if tenant:
            headers = dict(headers or {})
            headers["triton-tenant"] = str(tenant)
        return InferResult(self._unary("ModelInfer", frame,
                                       pb.ModelInferResponse, headers,
                                       client_timeout))

    def _infer_attempt(self, model_name, inputs, model_version, outputs,
                       request_id, sequence_id, sequence_start, sequence_end,
                       priority, timeout, client_timeout, headers,
                       parameters, tenant, remaining):
        """One attempt: what is left of the deadline as the ``timeout``
        parameter (where the call set none) and the transport timeout."""
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
                                tenant)

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
        _check_unported(compression_algorithm)
        return self._with_policy(
            retry_policy, deadline_s, model_name, request_id, "infer",
            lambda remaining: self._infer_attempt(
                model_name, inputs, model_version, outputs, request_id,
                sequence_id, sequence_start, sequence_end, priority,
                timeout, client_timeout, headers, parameters, tenant,
                remaining))

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
        _check_unported(compression_algorithm)
        request = get_inference_request(
            model_name, inputs, model_version, request_id, outputs,
            sequence_id, sequence_start, sequence_end, priority, timeout,
            parameters)
        frame = encode_frame(request)
        policy = retry_policy if retry_policy is not None \
            else self._retry_policy

        def attempt(remaining):
            if remaining is None or timeout is not None:
                return self._send_infer(frame, headers, client_timeout,
                                        tenant)
            request.parameters["timeout"] = pb.InferParameter(
                int64_param=remaining_us(remaining))
            return self._send_infer(encode_frame(request), headers,
                                    min_timeout(client_timeout, remaining),
                                    tenant)

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
        _check_unported(compression_algorithm)
        if stream_timeout is not None:
            _not_ported("stream_timeout", "A6b")
        if self._stream is not None:
            raise_error(
                "cannot start another stream with one already running. "
                "'InferenceServerClient' supports only a single active "
                "stream at a given time.")
        try:
            self._stream = _InferStream(self._url, callback,
                                        self._headers(headers),
                                        self._verbose)
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
        self._stream_send(encode_frame(request))

    def stop_stream(self, cancel_requests: bool = False) -> None:
        """Close the stream: after the server has answered every request
        sent, or at once with ``cancel_requests``."""
        stream, self._stream = self._stream, None
        if stream is not None:
            stream.close(cancel_requests)

