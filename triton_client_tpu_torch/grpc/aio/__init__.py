"""asyncio gRPC ``InferenceServerClient`` of the port.

Counterpart of ``triton_client_tpu/grpc/aio/__init__.py``: the sync gRPC
client's surface as ``async def``, ``PreparedRequest`` / ``infer_many``,
and ``stream_infer(inputs_iterator)``, which takes an async iterator of
request-kwarg dicts and returns a cancellable async iterator of
``(InferResult, error)`` (reference :749-827).

The reference runs on grpc.aio; here the calls go over HTTP/2 on
``asyncio`` streams (``_h2.py``, the sync client's wire: one connection,
every call a stream of it), chosen at the first call as the sync client
chooses: where the peer answers the HTTP/2 preface in HTTP/1.1 (the
port's HTTP port), they go as gRPC-Web on the port's own HTTP/1.1
(``_aio_http.py``, the transport that ``http.aio`` uses, framed with
``protocol/grpc_web.py``): unary calls on a pool of kept-alive
connections, a stream on a connection of its own.
``TC_TPU_GRPC_TRANSPORT=h2|web`` pins the wire.  ``stream_infer`` sends
each request as it comes from the iterator, while a task reads the
answers; its ``stream_timeout`` bounds the whole stream, and ``cancel()``
ends it (RST_STREAM over HTTP/2, its connection closed over gRPC-Web).
As in the reference, an in-band error is yielded as ``(None, error)``
and a failure of the call itself ends the iteration.

TLS and compression take the sync client's arguments (``ssl``,
``root_certificates``, ``private_key``, ``certificate_chain``, ``creds``
as an ``ssl.SSLContext``; ``compression_algorithm`` gzip or deflate
compresses the request frames).  ``keepalive_options`` and
``channel_args`` are taken and mean nothing here.
Telemetry counts every call under the ``grpc_aio`` protocol label, with
``traceparent`` on the wire.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import time
from typing import Dict, List, Optional

from ..._aio_http import AioConnectionPool
from ..._client import InferenceServerClientBase
from ..._request import Request
from ..._resilience import (RetryPolicy, call_with_retry_async,
                            deadline_exceeded_error, min_timeout,
                            remaining_us)
from ..._telemetry import merge_trace_headers, telemetry, traceparent_on_wire
from ..._uvloop import maybe_install_uvloop
from ...protocol import debug as pb_debug
from ...protocol import inference as pb
from ...protocol.grpc_web import (CONTENT_TYPE, TRAILER_FLAG, aiter_frames,
                                  compress_frame, encode_frame,
                                  parse_trailers)
from ...protocol.service import StatusCode, path
from ...utils import InferenceServerException, raise_error
from .._client import (_IDEMPOTENT, KeepAliveOptions, _maybe_json,
                       channel_ssl_context, compressed, grpc_encoding)
from .._infer_result import InferResult
from .._template import RequestTemplate
from .._transport import RpcError, http_error, unary_answer
from .._utils import (get_inference_request, raise_error_grpc,
                      stream_error_to_exception)
from ._h2 import select_transport

__all__ = ["InferenceServerClient", "KeepAliveOptions", "PreparedRequest"]

# the opt-in uvloop (TRITON_TPU_UVLOOP=1), before any loop of the caller's
maybe_install_uvloop()

#: kept-alive connections held for unary calls
_POOL_SIZE = 16


class PreparedRequest:
    """The aio sibling of the sync gRPC fast-path handle: a compiled
    :class:`RequestTemplate` bound to an aio client.  A stamp is a fresh
    frame, so concurrent tasks may share the handle."""

    def __init__(self, client, template: RequestTemplate):
        self._client = client
        self.template = template

    async def infer(self, request_id="", headers=None, tenant=None,
                    client_timeout=None,
                    retry_policy: Optional[RetryPolicy] = None,
                    deadline_s: Optional[float] = None) -> InferResult:
        client = self._client
        policy = retry_policy if retry_policy is not None \
            else client._retry_policy
        if policy is None and deadline_s is None:
            return await client._infer_prepared(
                self, request_id, headers, tenant, client_timeout)
        return await call_with_retry_async(
            policy,
            lambda remaining, _attempt: client._infer_prepared(
                self, request_id, headers, tenant, client_timeout,
                _remaining_s=remaining),
            method="infer", deadline_s=deadline_s,
            retry_meta=(self.template.model_name, "grpc_aio", "infer",
                        request_id), journey=True)


class InferenceServerClient(InferenceServerClientBase):
    """v2 protocol over gRPC-Web on asyncio streams."""

    def __init__(
        self,
        url: str,
        verbose: bool = False,
        ssl: bool = False,
        root_certificates: Optional[str] = None,
        private_key: Optional[str] = None,
        certificate_chain: Optional[str] = None,
        creds=None,
        keepalive_options: Optional[KeepAliveOptions] = None,
        channel_args=None,
        retry_policy: Optional[RetryPolicy] = None,
    ):
        super().__init__()
        if "://" in url:
            raise_error("url should not include the scheme")
        # client-level resilience default: health/metadata retry under it,
        # infer per its retry_infer opt-in
        self._retry_policy = retry_policy
        self._url = url
        self._verbose = verbose
        self._ssl_context = channel_ssl_context(
            ssl, root_certificates, private_key, certificate_chain, creds)
        self._pool = AioConnectionPool(url, _POOL_SIZE, self._ssl_context)
        self._streams: set = set()
        # the HTTP/2 transport, or None for gRPC-Web; chosen at the first
        # call (_wire_chosen)
        self._h2 = None
        self._wire_chosen = False
        self._wire_lock = asyncio.Lock()

    @property
    def url(self) -> str:
        """The ``host:port`` this client talks to."""
        return self._url

    # -- lifecycle ---------------------------------------------------------
    async def close(self) -> None:
        """Cancel the open streams and close every connection."""
        for it in list(self._streams):
            it.cancel()
        await self._pool.close()
        if self._h2 is not None:
            await self._h2.close()

    async def _wire(self):
        """The HTTP/2 transport, or None for gRPC-Web (RpcError where the
        server cannot be reached: the next call tries again)."""
        async with self._wire_lock:
            if not self._wire_chosen:
                self._h2 = await select_transport(self._url,
                                                  self._ssl_context)
                self._wire_chosen = True
            return self._h2

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        await self.close()

    def _get_metadata(self, headers: Optional[dict]) -> dict:
        request = Request(dict(headers) if headers else {})
        self._call_plugin(request)
        return request.headers

    async def _unary(self, method: str, frame: bytes, response_type,
                     headers: dict, client_timeout, sizes=None):
        """One unary call of an encoded request frame: its response, or
        :class:`RpcError`."""
        wire = await self._wire()
        if wire is not None:
            return await wire.unary(method, frame, response_type, headers,
                                    client_timeout, sizes)
        hdrs = dict(headers)
        hdrs["Content-Type"] = CONTENT_TYPE
        try:
            resp = await self._pool.request("POST", path(method), hdrs,
                                            frame, timeout=client_timeout)
        except TimeoutError:
            raise RpcError(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded")
        except (OSError, http.client.HTTPException) as e:
            raise RpcError(StatusCode.UNAVAILABLE, f"failed to connect: {e}")
        return unary_answer(resp.status, resp.headers, resp.data,
                            response_type, sizes)

    async def _call(self, method: str, request, response_type, headers,
                    client_timeout=None):
        """A control-plane RPC; the idempotent ones retry under the
        client's policy."""
        frame = encode_frame(request)
        hdrs = self._get_metadata(headers)

        async def attempt(remaining, _attempt=1):
            try:
                return await self._unary(method, frame, response_type, hdrs,
                                         min_timeout(client_timeout,
                                                     remaining))
            except RpcError as e:
                raise_error_grpc(e)

        kind = _IDEMPOTENT.get(method)
        if self._retry_policy is None or kind is None:
            response = await attempt(None)
        else:
            response = await call_with_retry_async(
                self._retry_policy, attempt, method=kind,
                retry_meta=("", "grpc_aio", kind, ""))
        if self._verbose:
            print(response)
        return response

    # -- health / metadata -------------------------------------------------
    async def is_server_live(self, headers=None, client_timeout=None) -> bool:
        return (await self._call("ServerLive", pb.ServerLiveRequest(),
                                 pb.ServerLiveResponse, headers,
                                 client_timeout)).live

    async def is_server_ready(self, headers=None,
                              client_timeout=None) -> bool:
        return (await self._call("ServerReady", pb.ServerReadyRequest(),
                                 pb.ServerReadyResponse, headers,
                                 client_timeout)).ready

    async def is_model_ready(self, model_name, model_version="", headers=None,
                             client_timeout=None) -> bool:
        return (await self._call(
            "ModelReady", pb.ModelReadyRequest(name=model_name,
                                               version=model_version),
            pb.ModelReadyResponse, headers, client_timeout)).ready

    async def get_server_metadata(self, headers=None, as_json=False,
                                  client_timeout=None):
        return _maybe_json(await self._call(
            "ServerMetadata", pb.ServerMetadataRequest(),
            pb.ServerMetadataResponse, headers, client_timeout), as_json)

    async def get_model_metadata(self, model_name, model_version="",
                                 headers=None, as_json=False,
                                 client_timeout=None):
        return _maybe_json(await self._call(
            "ModelMetadata", pb.ModelMetadataRequest(
                name=model_name, version=model_version),
            pb.ModelMetadataResponse, headers, client_timeout), as_json)

    async def get_model_config(self, model_name, model_version="",
                               headers=None, as_json=False,
                               client_timeout=None):
        return _maybe_json(await self._call(
            "ModelConfig", pb.ModelConfigRequest(
                name=model_name, version=model_version),
            pb.ModelConfigResponse, headers, client_timeout), as_json)

    # -- repository --------------------------------------------------------
    async def get_model_repository_index(self, headers=None, as_json=False,
                                         client_timeout=None):
        return _maybe_json(await self._call(
            "RepositoryIndex", pb.RepositoryIndexRequest(),
            pb.RepositoryIndexResponse, headers, client_timeout), as_json)

    async def load_model(self, model_name, headers=None,
                         config: Optional[str] = None,
                         files: Optional[Dict[str, bytes]] = None,
                         client_timeout=None):
        request = pb.RepositoryModelLoadRequest(model_name=model_name)
        if config is not None:
            request.parameters["config"] = pb.ModelRepositoryParameter(
                string_param=config)
        for name, content in (files or {}).items():
            request.parameters[name] = pb.ModelRepositoryParameter(
                bytes_param=content)
        await self._call("RepositoryModelLoad", request,
                         pb.RepositoryModelLoadResponse, headers,
                         client_timeout)

    async def unload_model(self, model_name, headers=None,
                           unload_dependents=False, client_timeout=None):
        request = pb.RepositoryModelUnloadRequest(model_name=model_name)
        request.parameters["unload_dependents"] = \
            pb.ModelRepositoryParameter(bool_param=unload_dependents)
        await self._call("RepositoryModelUnload", request,
                         pb.RepositoryModelUnloadResponse, headers,
                         client_timeout)

    # -- statistics / trace / logging --------------------------------------
    async def get_inference_statistics(self, model_name="", model_version="",
                                       headers=None, as_json=False,
                                       client_timeout=None):
        return _maybe_json(await self._call(
            "ModelStatistics", pb.ModelStatisticsRequest(
                name=model_name, version=model_version),
            pb.ModelStatisticsResponse, headers, client_timeout), as_json)

    async def update_trace_settings(self, model_name=None, settings=None,
                                    headers=None, as_json=False,
                                    client_timeout=None):
        request = pb.TraceSettingRequest(model_name=model_name or "")
        for key, value in (settings or {}).items():
            vals = ([] if value is None else value if isinstance(value, list)
                    else [str(value)])
            request.settings[key] = pb.TraceSettingRequest.SettingValue(
                value=vals)
        return _maybe_json(await self._call(
            "TraceSetting", request, pb.TraceSettingResponse, headers,
            client_timeout), as_json)

    async def get_trace_settings(self, model_name=None, headers=None,
                                 as_json=False, client_timeout=None):
        return await self.update_trace_settings(model_name, None, headers,
                                                as_json, client_timeout)

    async def update_log_settings(self, settings, headers=None, as_json=False,
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
        return _maybe_json(await self._call(
            "LogSettings", request, pb.LogSettingsResponse, headers,
            client_timeout), as_json)

    async def get_log_settings(self, headers=None, as_json=False,
                               client_timeout=None):
        return await self.update_log_settings({}, headers, as_json,
                                              client_timeout)

    async def get_flight_recorder(self, model_name=None, limit=0,
                                  headers=None, client_timeout=None) -> dict:
        """The flight recorder's snapshot (the HTTP route's JSON)."""
        return json.loads((await self._call(
            "FlightRecorder", pb_debug.FlightRecorderRequest(
                model_name=model_name or "", limit=int(limit or 0)),
            pb_debug.FlightRecorderResponse, headers,
            client_timeout)).payload_json)

    async def get_device_stats(self, model_name=None, headers=None,
                               client_timeout=None) -> dict:
        """The device statistics (the HTTP route's JSON)."""
        return json.loads((await self._call(
            "DeviceStats", pb_debug.DeviceStatsRequest(
                model_name=model_name or ""),
            pb_debug.DeviceStatsResponse, headers,
            client_timeout)).payload_json)

    async def get_costs(self, model_name=None, headers=None,
                        client_timeout=None) -> dict:
        """The cost ledger (the HTTP route's JSON)."""
        return json.loads((await self._call(
            "Costs", pb_debug.CostsRequest(model_name=model_name or ""),
            pb_debug.CostsResponse, headers, client_timeout)).payload_json)

    # -- shared memory -----------------------------------------------------
    async def get_system_shared_memory_status(self, region_name="",
                                              headers=None, as_json=False,
                                              client_timeout=None):
        return _maybe_json(await self._call(
            "SystemSharedMemoryStatus",
            pb.SystemSharedMemoryStatusRequest(name=region_name),
            pb.SystemSharedMemoryStatusResponse, headers, client_timeout),
            as_json)

    async def register_system_shared_memory(self, name, key, byte_size,
                                            offset=0, headers=None,
                                            client_timeout=None):
        await self._call("SystemSharedMemoryRegister",
                         pb.SystemSharedMemoryRegisterRequest(
                             name=name, key=key, offset=offset,
                             byte_size=byte_size),
                         pb.SystemSharedMemoryRegisterResponse, headers,
                         client_timeout)
        telemetry().record_shm_register("grpc_aio", "system", byte_size)

    async def unregister_system_shared_memory(self, name="", headers=None,
                                              client_timeout=None):
        await self._call("SystemSharedMemoryUnregister",
                         pb.SystemSharedMemoryUnregisterRequest(name=name),
                         pb.SystemSharedMemoryUnregisterResponse, headers,
                         client_timeout)

    async def get_cuda_shared_memory_status(self, region_name="",
                                            headers=None, as_json=False,
                                            client_timeout=None):
        return _maybe_json(await self._call(
            "CudaSharedMemoryStatus",
            pb.CudaSharedMemoryStatusRequest(name=region_name),
            pb.CudaSharedMemoryStatusResponse, headers, client_timeout),
            as_json)

    async def register_cuda_shared_memory(self, name, raw_handle: bytes,
                                          device_id: int, byte_size: int,
                                          headers=None, client_timeout=None):
        await self._call("CudaSharedMemoryRegister",
                         pb.CudaSharedMemoryRegisterRequest(
                             name=name, raw_handle=raw_handle,
                             device_id=device_id, byte_size=byte_size),
                         pb.CudaSharedMemoryRegisterResponse, headers,
                         client_timeout)
        telemetry().record_shm_register("grpc_aio", "cuda", byte_size)

    register_xla_shared_memory = register_cuda_shared_memory
    get_xla_shared_memory_status = get_cuda_shared_memory_status

    async def unregister_cuda_shared_memory(self, name="", headers=None,
                                            client_timeout=None):
        await self._call("CudaSharedMemoryUnregister",
                         pb.CudaSharedMemoryUnregisterRequest(name=name),
                         pb.CudaSharedMemoryUnregisterResponse, headers,
                         client_timeout)

    unregister_xla_shared_memory = unregister_cuda_shared_memory

    # -- inference ---------------------------------------------------------
    async def _send_infer(self, frame: bytes, headers, client_timeout,
                          tenant, model_name: str, request_id: str,
                          t_ser0: int, sink: Optional[list] = None,
                          encoding: Optional[str] = None) -> InferResult:
        """One ModelInfer call of an encoded request frame (the sync
        client's ``_send_infer``, under ``grpc_aio``)."""
        user = self._get_metadata(headers)
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
            response = await self._unary("ModelInfer", frame,
                                         pb.ModelInferResponse, sent,
                                         client_timeout, sizes)
        except RpcError as e:
            latency = time.perf_counter() - t0
            if sink is not None:
                sink.append((False, latency, req_bytes, 0, rid))
            else:
                tel.record_request(model_name, "grpc_aio", "infer", latency,
                                   ok=False, request_bytes=req_bytes,
                                   request_id=rid)
                if tel.tracing_enabled:
                    tel.record_infer_spans(
                        rid, model_name, "grpc_aio", "infer", t_ser0, t_ser1,
                        time.monotonic_ns(),
                        traceparent=traceparent_on_wire(user, trace_headers),
                        ok=False)
            raise_error_grpc(e)
        t_net1 = time.monotonic_ns()
        outcome = (True, time.perf_counter() - t0, req_bytes, sizes[0], rid)
        if sink is not None:
            sink.append(outcome)
        else:
            tel.record_request(model_name, "grpc_aio", "infer", outcome[1],
                               ok=True, request_bytes=req_bytes,
                               response_bytes=outcome[3], request_id=rid)
        result = InferResult(response)
        if tel.tracing_enabled:
            tel.record_infer_spans(
                rid, model_name, "grpc_aio", "infer", t_ser0, t_ser1, t_net1,
                traceparent=traceparent_on_wire(user, trace_headers))
        return result

    async def infer(
        self,
        model_name,
        inputs,
        model_version="",
        outputs=None,
        request_id="",
        sequence_id=0,
        sequence_start=False,
        sequence_end=False,
        priority=0,
        timeout=None,
        client_timeout=None,
        headers=None,
        compression_algorithm=None,
        parameters=None,
        retry_policy: Optional[RetryPolicy] = None,
        deadline_s: Optional[float] = None,
        tenant: Optional[str] = None,
    ) -> InferResult:
        """Async inference, with the sync client's resilience and QoS
        contract (each attempt stamps what is left of the deadline as the
        ``timeout`` parameter, where the call set none)."""
        encoding = grpc_encoding(compression_algorithm)

        async def attempt(remaining, _attempt=1):
            t_ser0 = time.monotonic_ns()
            t = timeout
            if t is None and remaining is not None:
                t = remaining_us(remaining)
            request = get_inference_request(
                model_name, inputs, model_version, request_id, outputs,
                sequence_id, sequence_start, sequence_end, priority, t,
                parameters)
            return await self._send_infer(
                encode_frame(request), headers,
                min_timeout(client_timeout, remaining), tenant, model_name,
                request_id, t_ser0, encoding=encoding)

        policy = retry_policy if retry_policy is not None \
            else self._retry_policy
        if policy is None and deadline_s is None:
            return await attempt(None)
        return await call_with_retry_async(
            policy, attempt, method="infer", deadline_s=deadline_s,
            retry_meta=(model_name, "grpc_aio", "infer", request_id),
            journey=True)

    # -- wire fast path ----------------------------------------------------
    def prepare(self, model_name, inputs, model_version="", outputs=None,
                priority=0, timeout=None, parameters=None) -> PreparedRequest:
        """Compile the fixed part of a request once (the sync client's
        ``prepare`` contract)."""
        return PreparedRequest(self, RequestTemplate(
            model_name, inputs, outputs, model_version, priority, timeout,
            parameters))

    async def _infer_prepared(self, prep: PreparedRequest, request_id,
                              headers, tenant, client_timeout=None,
                              _remaining_s=None, raws=None, _sink=None):
        t_ser0 = time.monotonic_ns()
        template = prep.template
        timeout_us = None
        if _remaining_s is not None and "timeout" not in template._params:
            timeout_us = remaining_us(_remaining_s)
        return await self._send_infer(
            template.stamp(request_id, timeout_us, raws), headers,
            min_timeout(client_timeout, _remaining_s), tenant,
            template.model_name, request_id, t_ser0, _sink)

    async def infer_many(
        self,
        model_name,
        requests,
        model_version="",
        outputs=None,
        priority=0,
        timeout=None,
        parameters=None,
        request_ids=None,
        headers=None,
        tenant: Optional[str] = None,
        client_timeout=None,
        retry_policy: Optional[RetryPolicy] = None,
        deadline_s: Optional[float] = None,
        window: int = 32,
    ) -> List[InferResult]:
        """Batch submit with at most ``window`` requests in flight: one
        compiled template, one retry and deadline envelope, one telemetry
        batch per flight; results in submission order, equal to N
        ``infer`` calls; a retry re-runs only the unanswered items."""
        items = list(requests)
        if not items:
            return []
        template = RequestTemplate(
            model_name, items[0], outputs, model_version, priority, timeout,
            parameters)
        prep = PreparedRequest(self, template)
        raws_list = [template.raws_for(item) for item in items]
        ids = list(request_ids) if request_ids else [""] * len(items)
        if len(ids) != len(items):
            raise_error("request_ids length must match requests")
        results: List[Optional[InferResult]] = [None] * len(items)
        done = [False] * len(items)
        tel = telemetry()

        async def flight(remaining, _attempt):
            # one deadline for the flight, read again as each item takes
            # a window slot
            deadline = (time.monotonic() + remaining
                        if remaining is not None else None)
            sem = asyncio.Semaphore(max(1, window))
            sink: list = []

            async def one(i):
                async with sem:
                    rem_i = None
                    if deadline is not None:
                        rem_i = deadline - time.monotonic()
                        if rem_i <= 0:
                            raise deadline_exceeded_error()
                    results[i] = await self._infer_prepared(
                        prep, ids[i], headers, tenant, client_timeout,
                        _remaining_s=rem_i, raws=raws_list[i], _sink=sink)
                    done[i] = True

            pending = [i for i, d in enumerate(done) if not d]
            try:
                outcomes = await asyncio.gather(
                    *(one(i) for i in pending), return_exceptions=True)
            finally:
                tel.record_request_batch(model_name, "grpc_aio", "infer",
                                         sink)
            for out in outcomes:
                if isinstance(out, BaseException):
                    raise out
            return results

        policy = retry_policy if retry_policy is not None \
            else self._retry_policy
        if policy is None and deadline_s is None:
            return await flight(None, 1)
        return await call_with_retry_async(
            policy, flight, method="infer", deadline_s=deadline_s,
            retry_meta=(model_name, "grpc_aio", "infer", ""))

    def stream_infer(self, inputs_iterator, stream_timeout=None, headers=None,
                     compression_algorithm=None):
        """A ModelStreamInfer call fed by ``inputs_iterator`` (an async
        iterator of ``infer``'s keyword dicts, with
        ``enable_empty_final_response``): a cancellable async iterator of
        ``(InferResult, error)``.  The call starts at the first ``async
        for`` step."""
        encoding = grpc_encoding(compression_algorithm)
        sent = self._get_metadata(headers)
        # one trace context per stream: its requests share it
        sent.update(merge_trace_headers(sent)[0])
        if encoding is not None:
            sent["grpc-encoding"] = encoding
        return _ResponseIterator(self, inputs_iterator, sent, encoding,
                                 stream_timeout)


_END = object()


class _H2StreamWriter:
    """A stream's request side over HTTP/2, as ``_send`` writes it (the
    gRPC-Web stream's ``write``, ``end`` and ``close``)."""

    def __init__(self, conn, call):
        self._conn, self._call = conn, call

    async def write(self, frame) -> None:
        await self._conn.send(self._call, frame)

    async def end(self) -> None:
        await self._conn.send(self._call, b"", end_stream=True)

    def close(self) -> None:
        self._conn.reset(self._call, StatusCode.CANCELLED,
                         "Locally cancelled by application!")


class _ResponseIterator:
    """The answers of one ``stream_infer`` call; ``cancel()`` ends it and
    closes its connection."""

    def __init__(self, client: InferenceServerClient, inputs_iterator,
                 headers: dict, encoding: Optional[str],
                 stream_timeout: Optional[float]):
        self._client = client
        self._inputs = inputs_iterator
        self._headers = headers
        self._encoding = encoding
        self._timeout = stream_timeout
        self._task: Optional[asyncio.Task] = None
        self._queue: Optional[asyncio.Queue] = None
        self._error: Optional[BaseException] = None
        self._cancelled = False

    def __aiter__(self):
        return self

    async def __anext__(self):
        if self._task is None:
            if self._cancelled:
                raise StopAsyncIteration
            self._queue = asyncio.Queue()
            self._task = asyncio.ensure_future(self._run())
            self._client._streams.add(self)
        item = await self._queue.get()
        if item is _END:
            self._queue.put_nowait(_END)  # every later step ends too
            if self._error is not None:
                error, self._error = self._error, None
                raise error
            raise StopAsyncIteration
        return item

    def cancel(self) -> bool:
        """End the stream: its connection closes and the iteration stops.
        False where it had ended already."""
        self._cancelled = True
        if self._task is None:
            return True
        return self._task.cancel()

    async def _send(self, stream) -> None:
        """Each request of the iterator as one chunk, as it comes; then the
        end of the request body.  A failure here (an invalid request dict,
        the iterator's own error) closes the stream and is raised to the
        consumer."""
        try:
            await self._send_all(stream)
        except Exception as e:  # noqa: BLE001 - raised by __anext__
            self._error = e
            stream.close()

    async def _send_all(self, stream) -> None:
        async for kwargs in self._inputs:
            if not isinstance(kwargs, dict):
                raise_error("inputs_iterator is not yielding a dict")
            if "model_name" not in kwargs or "inputs" not in kwargs:
                raise_error("model_name and/or inputs is missing from "
                            "inputs_iterator's yielded dict")
            kwargs = dict(kwargs)
            empty_final = kwargs.pop("enable_empty_final_response", False)
            request = get_inference_request(
                kwargs["model_name"], kwargs["inputs"],
                kwargs.get("model_version", ""),
                kwargs.get("request_id", ""), kwargs.get("outputs"),
                kwargs.get("sequence_id", 0),
                kwargs.get("sequence_start", False),
                kwargs.get("sequence_end", False),
                kwargs.get("priority", 0), kwargs.get("timeout"),
                kwargs.get("parameters"))
            if empty_final:
                request.parameters["triton_enable_empty_final_response"] = \
                    pb.InferParameter(bool_param=True)
            frame = encode_frame(request)
            telemetry().record_request(
                kwargs["model_name"], "grpc_aio", "stream_infer", None,
                ok=True, request_bytes=len(frame) - 5,
                request_id=kwargs.get("request_id", ""))
            if self._encoding is not None:
                frame = compress_frame(frame, self._encoding)
            await stream.write(frame)
        await stream.end()

    def _answer(self, payload) -> None:
        response = pb.ModelStreamInferResponse.FromString(payload)
        if response.error_message:
            self._queue.put_nowait((None, stream_error_to_exception(
                response.error_message)))
        else:
            self._queue.put_nowait(
                (InferResult(response.infer_response), None))

    async def _run(self) -> None:
        try:
            wire = await self._client._wire()
        except RpcError as e:
            if self._client._verbose:
                print(f"stream ended: {e!r}")
            self._client._streams.discard(self)
            self._queue.put_nowait(_END)
            return
        if wire is not None:
            await self._run_h2(wire)
        else:
            await self._run_web()

    async def _run_h2(self, wire) -> None:
        conn = call = sender = None
        try:
            async with asyncio.timeout(self._timeout):
                conn = await wire.connection()
                call = conn.start("ModelStreamInfer", self._headers,
                                  self._timeout, stream=True)
                sender = asyncio.ensure_future(
                    self._send(_H2StreamWriter(conn, call)))
                async for payload in conn.messages(call):
                    self._answer(payload)
                if call.code != StatusCode.OK:
                    raise InferenceServerException(msg=call.message,
                                                   status=str(call.code))
        except (InferenceServerException, RpcError, TimeoutError,
                OSError) as e:
            if self._client._verbose:
                print(f"stream ended: {e!r}")
        finally:
            if sender is not None and not sender.done():
                sender.cancel()
            if call is not None and not call.complete:
                conn.reset(call, StatusCode.CANCELLED,
                           "Locally cancelled by application!")
            self._client._streams.discard(self)
            self._queue.put_nowait(_END)

    async def _run_web(self) -> None:
        stream = None
        sender = None
        headers = dict(self._headers, **{"Content-Type": CONTENT_TYPE})
        try:
            async with asyncio.timeout(self._timeout):
                stream = await self._client._pool.open_stream(
                    "POST", path("ModelStreamInfer"), headers)
                sender = asyncio.ensure_future(self._send(stream))
                status, headers = await stream.read_head()
                if status != 200:
                    err = http_error(status, await stream.read_to_end(
                        headers))
                    raise InferenceServerException(
                        msg=err.details(), status=str(err.code()))
                async for flags, payload in aiter_frames(stream.chunks()):
                    if flags & TRAILER_FLAG:
                        code, message = parse_trailers(payload)
                        if code != StatusCode.OK:
                            raise InferenceServerException(
                                msg=message, status=str(code))
                        continue
                    self._answer(payload)
        except (InferenceServerException, TimeoutError, OSError, ValueError,
                http.client.HTTPException) as e:
            # a failure of the call ends the iteration, as a grpc.aio
            # RpcError does in the reference
            if self._client._verbose:
                print(f"stream ended: {e!r}")
        finally:
            if sender is not None and not sender.done():
                sender.cancel()
            if stream is not None:
                stream.close()
            self._client._streams.discard(self)
            self._queue.put_nowait(_END)
