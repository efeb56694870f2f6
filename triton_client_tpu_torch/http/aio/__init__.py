"""asyncio HTTP ``InferenceServerClient`` of the port.

Counterpart of ``triton_client_tpu/http/aio/__init__.py``: the sync HTTP
client's surface as ``async def`` (its one sync-only name is
``async_infer``), the same URIs, binary-tensor framing, statics and
``PreparedRequest`` / ``infer_many``.  The reference runs on an aiohttp
session; the machine the port serves on has no aiohttp, so this client
speaks HTTP/1.1 itself on ``asyncio`` streams (``_aio_http.py``): a pool
of at most ``conn_limit`` kept-alive connections, ``conn_timeout`` the
total of one request (``TimeoutError`` past it), a cancelled or timed-out
request's connection closed, never pooled.  Response bodies come back as
sent and are decompressed here (the reference's ``auto_decompress=False``
and ``_decompress``).  ``ssl=True`` talks HTTPS with ``ssl_context`` (an
``ssl.SSLContext``; the default context, which verifies against the
system's CAs, without one).  Telemetry counts every call under the
``http_aio`` protocol label, with ``traceparent`` on the wire.
"""

from __future__ import annotations

import asyncio
import base64
import gzip
import json
import ssl as _ssl
import time
import zlib
from typing import Any, Dict, List, Optional
from urllib.parse import quote, urlencode

from ..._aio_http import AioConnectionPool, decompress
from ..._client import InferenceServerClientBase
from ..._request import Request
from ..._resilience import (RetryPolicy, call_with_retry_async,
                            deadline_exceeded_error, min_timeout,
                            normalized_status, remaining_us)
from ..._telemetry import (merge_trace_headers, telemetry,
                           traceparent_on_wire)
from ..._uvloop import maybe_install_uvloop
from ...utils import InferenceServerException, raise_error
from .._infer_result import InferResult
from .._template import RequestTemplate
from .._utils import get_inference_request_body, raise_if_error

__all__ = ["InferenceServerClient", "PreparedRequest"]

# the opt-in uvloop (TRITON_TPU_UVLOOP=1), before any loop of the caller's
maybe_install_uvloop()


class PreparedRequest:
    """Async sibling of the sync client's fast-path handle: a compiled
    :class:`RequestTemplate` bound to an aio client (same template class —
    it is immutable and loop-agnostic)."""

    def __init__(self, client, template: RequestTemplate):
        self._client = client
        self.template = template
        path = f"v2/models/{quote(template.model_name)}"
        if template.model_version:
            path += f"/versions/{template.model_version}"
        self.infer_path = path + "/infer"

    async def infer(self, request_id="", headers=None, query_params=None,
                    tenant=None,
                    retry_policy: Optional[RetryPolicy] = None,
                    deadline_s: Optional[float] = None) -> InferResult:
        client = self._client
        policy = retry_policy if retry_policy is not None \
            else client._retry_policy
        if policy is None and deadline_s is None:
            return await client._infer_prepared(
                self, request_id, headers, query_params, tenant)
        return await call_with_retry_async(
            policy,
            lambda remaining, _attempt: client._infer_prepared(
                self, request_id, headers, query_params, tenant,
                _remaining_s=remaining),
            method="infer", deadline_s=deadline_s,
            retry_meta=(self.template.model_name, "http_aio", "infer",
                        request_id), journey=True)


class InferenceServerClient(InferenceServerClientBase):
    """v2 protocol over the port's HTTP/1.1 on asyncio streams."""

    def __init__(
        self,
        url: str,
        verbose: bool = False,
        conn_limit: int = 100,
        conn_timeout: float = 60.0,
        ssl: bool = False,
        ssl_context=None,
        retry_policy: Optional[RetryPolicy] = None,
    ):
        super().__init__()
        # client-level resilience default (see the sync client): health/
        # metadata retry unconditionally, infer per its retry_infer opt-in
        self._retry_policy = retry_policy
        if url.startswith("http://") or url.startswith("https://"):
            raise_error("url should not include the scheme")
        self._url = url
        # "host[:port][/base path]"
        host, _, base = url.partition("/")
        self._base_path = "/" + base.rstrip("/") if base.strip("/") else ""
        self._verbose = verbose
        if ssl and ssl_context is None:
            ssl_context = _ssl.create_default_context()
        self._pool = AioConnectionPool(host, conn_limit,
                                       ssl_context if ssl else None)
        self._conn_timeout = conn_timeout

    @property
    def url(self) -> str:
        """The scheme-less ``host:port`` this client talks to — the
        endpoint label the cluster layer keys its routing counters by."""
        return self._url

    # -- lifecycle ---------------------------------------------------------
    async def close(self) -> None:
        await self._pool.close()

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        await self.close()

    # -- low-level ---------------------------------------------------------
    def _build_headers(self, headers: Optional[dict]) -> dict:
        request = Request(dict(headers) if headers else {})
        self._call_plugin(request)
        # reference aio client :122-134: hop-by-hop framing headers would
        # corrupt the binary-over-HTTP body; reject rather than forward
        bad = [
            k
            for k in request.headers
            if k.lower() in ("transfer-encoding",)
        ]
        if bad:
            raise_error(
                f"Unsupported headers {bad}; use a different client or "
                "remove them."
            )
        return request.headers

    def _uri(self, path: str, query_params: Optional[dict]) -> str:
        uri = f"{self._base_path}/{path}"
        if query_params:
            uri += "?" + urlencode(query_params, doseq=True)
        return uri

    async def _get(self, path, headers, query_params,
                   timeout_s=None) -> tuple:
        uri = self._uri(path, query_params)
        if self._verbose:
            print(f"GET {uri}")
        # a deadline's budget caps (never replaces) conn_timeout
        resp = await self._pool.request(
            "GET", uri, self._build_headers(headers),
            timeout=min_timeout(self._conn_timeout, timeout_s))
        return resp.status, resp.headers, decompress(resp.headers,
                                                     resp.data)

    async def _post(self, path, body, headers, query_params,
                    extra_headers=None, timeout_s=None) -> tuple:
        uri = self._uri(path, query_params)
        hdrs = self._build_headers(headers)
        if extra_headers:
            hdrs.update(extra_headers)
        if self._verbose:
            print(f"POST {uri}")
        # the deadline's budget caps conn_timeout: a short conn_timeout
        # keeps guarding each attempt under a generous budget
        resp = await self._pool.request(
            "POST", uri, hdrs, body,
            timeout=min_timeout(self._conn_timeout, timeout_s))
        return resp.status, resp.headers, decompress(resp.headers,
                                                     resp.data)

    async def _with_retry(self, method_kind: str, fn):
        """Run an idempotent (health/metadata) call under the client-level
        retry policy, if one is configured.  ``fn(timeout_s)`` receives
        the remaining deadline budget so each attempt is capped."""
        if self._retry_policy is None:
            return await fn(None)

        async def _attempt(remaining, _att):
            return await fn(remaining)

        return await call_with_retry_async(
            self._retry_policy, _attempt, method=method_kind,
            retry_meta=("", "http_aio", method_kind, ""))

    async def _health_get(self, path, headers, query_params) -> bool:
        """Health probe with 429/503 retry under a policy, degrading to
        the no-raise boolean once retries are exhausted (see the sync
        client)."""
        async def _call(remaining):
            status, hdrs, body = await self._get(
                path, headers, query_params, timeout_s=remaining)
            if self._retry_policy is not None and status in (429, 503):
                raise_if_error(status, body, hdrs)
            return status

        try:
            status = await self._with_retry("health", _call)
        except InferenceServerException as e:
            if normalized_status(e) in ("429", "503"):
                return False  # still overloaded after every retry
            raise
        return status == 200

    # -- health / metadata -------------------------------------------------
    async def is_server_live(self, headers=None, query_params=None) -> bool:
        return await self._health_get("v2/health/live", headers,
                                      query_params)

    async def is_server_ready(self, headers=None, query_params=None) -> bool:
        return await self._health_get("v2/health/ready", headers,
                                      query_params)

    async def is_model_ready(
        self, model_name, model_version="", headers=None, query_params=None
    ) -> bool:
        path = f"v2/models/{quote(model_name)}"
        if model_version:
            path += f"/versions/{model_version}"
        return await self._health_get(f"{path}/ready", headers,
                                      query_params)

    async def get_server_metadata(self, headers=None, query_params=None) -> dict:
        async def _call(remaining):
            status, hdrs, body = await self._get(
                "v2", headers, query_params, timeout_s=remaining)
            raise_if_error(status, body, hdrs)
            return body

        return json.loads(await self._with_retry("metadata", _call))

    async def get_model_metadata(
        self, model_name, model_version="", headers=None, query_params=None
    ) -> dict:
        path = f"v2/models/{quote(model_name)}"
        if model_version:
            path += f"/versions/{model_version}"

        async def _call(remaining):
            status, hdrs, body = await self._get(
                path, headers, query_params, timeout_s=remaining)
            raise_if_error(status, body, hdrs)
            return body

        return json.loads(await self._with_retry("metadata", _call))

    async def get_model_config(
        self, model_name, model_version="", headers=None, query_params=None
    ) -> dict:
        path = f"v2/models/{quote(model_name)}"
        if model_version:
            path += f"/versions/{model_version}"

        async def _call(remaining):
            status, hdrs, body = await self._get(
                f"{path}/config", headers, query_params,
                timeout_s=remaining)
            raise_if_error(status, body, hdrs)
            return body

        return json.loads(await self._with_retry("metadata", _call))

    # -- repository --------------------------------------------------------
    async def get_model_repository_index(self, headers=None, query_params=None) -> list:
        status, _, body = await self._post("v2/repository/index", b"", headers, query_params)
        raise_if_error(status, body)
        return json.loads(body)

    async def load_model(
        self, model_name, headers=None, query_params=None,
        config: Optional[str] = None, files: Optional[Dict[str, bytes]] = None,
    ) -> None:
        load_request: Dict[str, Any] = {}
        if config is not None or files:
            load_request["parameters"] = {}
        if config is not None:
            load_request["parameters"]["config"] = config
        if files:
            for path, content in files.items():
                load_request["parameters"][path] = base64.b64encode(content).decode()
        status, _, body = await self._post(
            f"v2/repository/models/{quote(model_name)}/load",
            json.dumps(load_request).encode() if load_request else b"",
            headers, query_params,
        )
        raise_if_error(status, body)

    async def unload_model(
        self, model_name, headers=None, query_params=None, unload_dependents=False
    ) -> None:
        body = {"parameters": {"unload_dependents": unload_dependents}}
        status, _, data = await self._post(
            f"v2/repository/models/{quote(model_name)}/unload",
            json.dumps(body).encode(), headers, query_params,
        )
        raise_if_error(status, data)

    # -- statistics / trace / logging --------------------------------------
    async def get_inference_statistics(
        self, model_name="", model_version="", headers=None, query_params=None
    ) -> dict:
        if model_name:
            path = f"v2/models/{quote(model_name)}"
            if model_version:
                path += f"/versions/{model_version}"
            path += "/stats"
        else:
            path = "v2/models/stats"
        status, _, body = await self._get(path, headers, query_params)
        raise_if_error(status, body)
        return json.loads(body)

    async def update_trace_settings(
        self, model_name=None, settings=None, headers=None, query_params=None
    ) -> dict:
        path = (
            f"v2/models/{quote(model_name)}/trace/setting" if model_name else "v2/trace/setting"
        )
        status, _, body = await self._post(
            path, json.dumps(settings or {}).encode(), headers, query_params
        )
        raise_if_error(status, body)
        return json.loads(body)

    async def get_trace_settings(self, model_name=None, headers=None, query_params=None) -> dict:
        path = (
            f"v2/models/{quote(model_name)}/trace/setting" if model_name else "v2/trace/setting"
        )
        status, _, body = await self._get(path, headers, query_params)
        raise_if_error(status, body)
        return json.loads(body)

    async def update_log_settings(self, settings, headers=None, query_params=None) -> dict:
        status, _, body = await self._post(
            "v2/logging", json.dumps(settings).encode(), headers, query_params
        )
        raise_if_error(status, body)
        return json.loads(body)

    async def get_log_settings(self, headers=None, query_params=None) -> dict:
        status, _, body = await self._get("v2/logging", headers, query_params)
        raise_if_error(status, body)
        return json.loads(body)

    async def get_flight_recorder(self, model_name=None, limit=0,
                                  headers=None, query_params=None) -> dict:
        """The server's flight-recorder debug snapshot (always-on recent
        ring + pinned tail-latency/failure outliers with span trees)."""
        params = dict(query_params or {})
        if model_name:
            params["model"] = model_name
        if limit:
            params["limit"] = limit
        status, _, body = await self._get(
            "v2/debug/flight_recorder", headers, params or None)
        raise_if_error(status, body)
        return json.loads(body)

    async def get_device_stats(self, model_name=None, headers=None,
                               query_params=None) -> dict:
        """The server's device/scheduler observability snapshot (duty
        cycle / live MFU / compiles / ticks / transfers / HBM + SLO
        state) — same JSON as GET /v2/debug/device_stats."""
        params = dict(query_params or {})
        if model_name:
            params["model"] = model_name
        status, _, body = await self._get(
            "v2/debug/device_stats", headers, params or None)
        raise_if_error(status, body)
        return json.loads(body)

    async def get_costs(self, model_name=None, headers=None,
                        query_params=None) -> dict:
        """The server's per-tenant cost-attribution ledger: device-time,
        FLOPs, generated tokens, and KV byte-seconds per (model, tenant)
        — GET /v2/debug/costs."""
        params = dict(query_params or {})
        if model_name:
            params["model"] = model_name
        status, _, body = await self._get(
            "v2/debug/costs", headers, params or None)
        raise_if_error(status, body)
        return json.loads(body)

    # -- shared memory -----------------------------------------------------
    async def get_system_shared_memory_status(
        self, region_name="", headers=None, query_params=None
    ) -> list:
        path = "v2/systemsharedmemory"
        if region_name:
            path += f"/region/{quote(region_name)}"
        status, _, body = await self._get(f"{path}/status", headers, query_params)
        raise_if_error(status, body)
        return json.loads(body)

    async def register_system_shared_memory(
        self, name, key, byte_size, offset=0, headers=None, query_params=None
    ) -> None:
        body = {"key": key, "offset": offset, "byte_size": byte_size}
        status, _, data = await self._post(
            f"v2/systemsharedmemory/region/{quote(name)}/register",
            json.dumps(body).encode(), headers, query_params,
        )
        raise_if_error(status, data)
        telemetry().record_shm_register("http_aio", "system", byte_size)

    async def unregister_system_shared_memory(
        self, name="", headers=None, query_params=None
    ) -> None:
        if name:
            path = f"v2/systemsharedmemory/region/{quote(name)}/unregister"
        else:
            path = "v2/systemsharedmemory/unregister"
        status, _, data = await self._post(path, b"", headers, query_params)
        raise_if_error(status, data)

    async def get_cuda_shared_memory_status(
        self, region_name="", headers=None, query_params=None
    ) -> list:
        path = "v2/cudasharedmemory"
        if region_name:
            path += f"/region/{quote(region_name)}"
        status, _, body = await self._get(f"{path}/status", headers, query_params)
        raise_if_error(status, body)
        return json.loads(body)

    async def register_cuda_shared_memory(
        self, name, raw_handle: bytes, device_id: int, byte_size: int,
        headers=None, query_params=None,
    ) -> None:
        body = {
            "raw_handle": {"b64": base64.b64encode(raw_handle).decode()},
            "device_id": device_id,
            "byte_size": byte_size,
        }
        status, _, data = await self._post(
            f"v2/cudasharedmemory/region/{quote(name)}/register",
            json.dumps(body).encode(), headers, query_params,
        )
        raise_if_error(status, data)
        telemetry().record_shm_register("http_aio", "cuda", byte_size)

    register_xla_shared_memory = register_cuda_shared_memory
    get_xla_shared_memory_status = get_cuda_shared_memory_status

    async def unregister_cuda_shared_memory(self, name="", headers=None, query_params=None) -> None:
        if name:
            path = f"v2/cudasharedmemory/region/{quote(name)}/unregister"
        else:
            path = "v2/cudasharedmemory/unregister"
        status, _, data = await self._post(path, b"", headers, query_params)
        raise_if_error(status, data)

    unregister_xla_shared_memory = unregister_cuda_shared_memory

    # -- inference ---------------------------------------------------------
    # store-and-forward statics (reference aio :661-689): same contract as
    # the sync client's — aliased so the two cannot drift
    from .._client import InferenceServerClient as _Sync

    generate_request_body = staticmethod(_Sync.generate_request_body)
    parse_response_body = staticmethod(_Sync.parse_response_body)
    del _Sync

    # -- wire fast path ----------------------------------------------------
    def prepare(
        self,
        model_name,
        inputs,
        model_version="",
        outputs=None,
        priority=0,
        timeout=None,
        parameters=None,
    ) -> PreparedRequest:
        """Compile the invariant request skeleton once (sync client's
        ``prepare`` contract; the template is shared machinery)."""
        return PreparedRequest(self, RequestTemplate(
            model_name, inputs, outputs, model_version, priority, timeout,
            parameters))

    async def _infer_prepared(self, prep: PreparedRequest, request_id,
                              headers, query_params, tenant,
                              _remaining_s=None, raws=None, _sink=None):
        """One stamped-request round trip (see the sync client's sibling
        for the ``_sink`` batch-telemetry contract)."""
        tel = telemetry()
        t_ser0 = time.monotonic_ns()
        body, json_size = prep.template.stamp(request_id, raws)
        extra_headers = {}
        if tenant:
            extra_headers["triton-tenant"] = str(tenant)
        if json_size is not None:
            extra_headers["Inference-Header-Content-Length"] = str(json_size)
        trace_headers, rid = merge_trace_headers(headers, request_id)
        extra_headers.update(trace_headers)
        if _remaining_s is not None:
            extra_headers["triton-timeout-us"] = str(
                remaining_us(_remaining_s))
        t_ser1 = time.monotonic_ns()
        t0 = time.perf_counter()
        try:
            status, resp_headers, data = await self._post(
                prep.infer_path, body, headers, query_params, extra_headers,
                timeout_s=_remaining_s)
            raise_if_error(status, data, resp_headers)
        except Exception:
            if _sink is not None:
                _sink.append((False, time.perf_counter() - t0, len(body),
                              0, rid))
            else:
                tel.record_request(
                    prep.template.model_name, "http_aio", "infer",
                    time.perf_counter() - t0, ok=False,
                    request_bytes=len(body), request_id=rid)
                if tel.tracing_enabled:
                    tel.record_infer_spans(
                        rid, prep.template.model_name, "http_aio", "infer",
                        t_ser0, t_ser1, time.monotonic_ns(),
                        traceparent=traceparent_on_wire(
                            headers, trace_headers),
                        ok=False)
            raise
        t_net1 = time.monotonic_ns()
        if _sink is not None:
            _sink.append((True, time.perf_counter() - t0, len(body),
                          len(data), rid))
        else:
            tel.record_request(
                prep.template.model_name, "http_aio", "infer",
                time.perf_counter() - t0, ok=True, request_bytes=len(body),
                response_bytes=len(data), request_id=rid)
        header_length = resp_headers.get("Inference-Header-Content-Length")
        result = InferResult(
            data, self._verbose,
            int(header_length) if header_length is not None else None,
            None, headers=resp_headers)
        if tel.tracing_enabled:
            tel.record_infer_spans(
                rid, prep.template.model_name, "http_aio", "infer",
                t_ser0, t_ser1, t_net1,
                traceparent=traceparent_on_wire(headers, trace_headers))
        return result

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
        query_params=None,
        tenant: Optional[str] = None,
        retry_policy: Optional[RetryPolicy] = None,
        deadline_s: Optional[float] = None,
        window: int = 32,
    ) -> List[InferResult]:
        """Batch submit with a bounded-concurrency gather (``window``
        in-flight at once): one compiled template, one retry/deadline
        envelope, one locked telemetry batch per flight.  Results keep
        submission order and equal N sequential ``infer`` calls; a retry
        re-runs only the items that had not completed."""
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
            # ONE deadline for the whole flight, re-derived as each item
            # acquires a window slot (a slow batch raises instead of
            # granting every window the full budget)
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
                        prep, ids[i], headers, query_params, tenant,
                        _remaining_s=rem_i, raws=raws_list[i],
                        _sink=sink)
                    done[i] = True

            pending = [i for i, d in enumerate(done) if not d]
            try:
                outcomes = await asyncio.gather(
                    *(one(i) for i in pending), return_exceptions=True)
            finally:
                tel.record_request_batch(
                    model_name, "http_aio", "infer", sink)
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
            retry_meta=(model_name, "http_aio", "infer", ""))

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
        headers=None,
        query_params=None,
        request_compression_algorithm=None,
        response_compression_algorithm=None,
        parameters=None,
        retry_policy: Optional[RetryPolicy] = None,
        deadline_s: Optional[float] = None,
        tenant: Optional[str] = None,
    ) -> InferResult:
        """Async inference (reference aio :694).  ``retry_policy`` /
        ``deadline_s``: same resilience contract as the sync client;
        ``priority``/``tenant``: the QoS identity, re-stamped per
        attempt so retries carry it."""
        policy = retry_policy if retry_policy is not None \
            else self._retry_policy
        if policy is None and deadline_s is None:
            return await self._infer_once(
                model_name, inputs, model_version, outputs, request_id,
                sequence_id, sequence_start, sequence_end, priority, timeout,
                headers, query_params, request_compression_algorithm,
                response_compression_algorithm, parameters, tenant)
        return await call_with_retry_async(
            policy,
            lambda remaining, _attempt: self._infer_once(
                model_name, inputs, model_version, outputs, request_id,
                sequence_id, sequence_start, sequence_end, priority, timeout,
                headers, query_params, request_compression_algorithm,
                response_compression_algorithm, parameters, tenant,
                _remaining_s=remaining),
            method="infer", deadline_s=deadline_s,
            retry_meta=(model_name, "http_aio", "infer", request_id),
            journey=True)

    async def _infer_once(
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
        headers=None,
        query_params=None,
        request_compression_algorithm=None,
        response_compression_algorithm=None,
        parameters=None,
        tenant=None,
        _remaining_s=None,
    ) -> InferResult:
        tel = telemetry()
        t_ser0 = time.monotonic_ns()
        body, json_size = get_inference_request_body(
            inputs, request_id, outputs, sequence_id, sequence_start, sequence_end,
            priority, timeout, parameters,
        )
        extra_headers = {}
        if tenant:
            # QoS identity: same header contract as the sync client
            extra_headers["triton-tenant"] = str(tenant)
        if request_compression_algorithm == "gzip":
            body = gzip.compress(body)
            extra_headers["Content-Encoding"] = "gzip"
        elif request_compression_algorithm == "deflate":
            body = zlib.compress(body)
            extra_headers["Content-Encoding"] = "deflate"
        if response_compression_algorithm in ("gzip", "deflate"):
            extra_headers["Accept-Encoding"] = response_compression_algorithm
        if json_size is not None:
            extra_headers["Inference-Header-Content-Length"] = str(json_size)
        # trace propagation: same contract as the sync client (server
        # records the id in trace JSON and echoes it back)
        trace_headers, rid = merge_trace_headers(headers, request_id)
        extra_headers.update(trace_headers)
        if _remaining_s is not None:
            # remaining deadline budget, restamped per attempt
            extra_headers["triton-timeout-us"] = str(
                remaining_us(_remaining_s))
        t_ser1 = time.monotonic_ns()

        path = f"v2/models/{quote(model_name)}"
        if model_version:
            path += f"/versions/{model_version}"
        path += "/infer"
        t0 = time.perf_counter()
        try:
            status, resp_headers, data = await self._post(
                path, body, headers, query_params, extra_headers,
                timeout_s=_remaining_s
            )
            raise_if_error(status, data, resp_headers)
        except Exception:
            tel.record_request(
                model_name, "http_aio", "infer", time.perf_counter() - t0,
                ok=False, request_bytes=len(body),
                request_id=rid)
            if tel.tracing_enabled:
                # failed attempts stay on the journey's trace (see the
                # sync client) — the journeys report counts every attempt
                tel.record_infer_spans(
                    rid, model_name, "http_aio", "infer", t_ser0, t_ser1,
                    time.monotonic_ns(),
                    traceparent=traceparent_on_wire(headers, trace_headers),
                    ok=False)
            raise
        t_net1 = time.monotonic_ns()
        tel.record_request(
            model_name, "http_aio", "infer", time.perf_counter() - t0,
            ok=True, request_bytes=len(body), response_bytes=len(data),
            request_id=rid)
        header_length = resp_headers.get("Inference-Header-Content-Length")
        result = InferResult(
            data, self._verbose,
            int(header_length) if header_length is not None else None, None,
            headers=resp_headers,
        )
        if tel.tracing_enabled:
            tel.record_infer_spans(
                rid, model_name, "http_aio", "infer", t_ser0, t_ser1, t_net1,
                traceparent=traceparent_on_wire(headers, trace_headers))
        return result

