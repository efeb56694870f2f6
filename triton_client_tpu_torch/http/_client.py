"""Synchronous HTTP/REST ``InferenceServerClient`` of the port.

Counterpart of ``triton_client_tpu/http/_client.py``, with the same method
names, signatures, URIs and binary-tensor framing
(``Inference-Header-Content-Length``).  The reference sends through a
``urllib3`` pool; the machine the port serves on has no ``urllib3``, so
this client keeps its own pool of ``http.client.HTTPConnection``\\ s on the
standard library: up to ``concurrency`` idle connections, all kept alive
and shared by threads.  ``http.client`` sets ``TCP_NODELAY`` on each
connection and sends a ``bytes`` body in one write with the headers, so a
request costs no delayed-ACK wait on either side.

A kept-alive connection that the server closed while it sat in the pool is
found on its next use: a request is sent again on another connection only
where it failed on a reused connection before any byte of a response
arrived (a peek at the socket tells).  Every other failure is raised.

The trace and log settings (``update_trace_settings``,
``get_trace_settings``, ``update_log_settings``, ``get_log_settings``) and
the debug snapshots (``get_flight_recorder``, ``get_device_stats``,
``get_costs``) are the reference's calls on the same routes.

Resilience and QoS, as in the reference: ``infer``, ``async_infer`` and a
prepared request's ``infer`` take ``retry_policy`` (else the client's),
``deadline_s``, ``tenant`` (the ``triton-tenant`` header) and ``priority``.
Under a policy or a deadline each attempt goes out on a pooled connection
with ``triton-timeout-us`` stamped anew from what is left of the deadline,
which also caps the attempt's socket timeout; a refusal's pushback
(``triton-retry-after-ms``) sets the wait before the next one
(``_resilience.py``).  Under a client-level policy the health and metadata
calls retry too.

Not ported yet: client telemetry beyond the retry count and tracing
headers (ROADMAP A6b); TLS and the repository API (ROADMAP A3b).
``infer_many`` and the ``xla`` aliases of the CUDA shared-memory calls are
not ported.
"""

from __future__ import annotations

import gzip
import http.client
import json
import socket
import threading
import zlib
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeoutError
from typing import Deque, Dict, Optional, Tuple
from urllib.parse import quote, urlencode

from .._client import InferenceServerClientBase
from .._request import Request
from .._resilience import (call_with_retry, min_timeout, normalized_status,
                           remaining_us)
from ..utils import InferenceServerException, raise_error
from ._infer_result import InferResult
from ._template import RequestTemplate
from ._utils import get_inference_request_body, raise_if_error


def _not_ported(name: str, item: str):
    raise NotImplementedError(
        f"{name} is not ported to triton_client_tpu_torch yet (ROADMAP "
        f"{item})")


class _Response:
    """One HTTP response read whole: status, headers and body."""

    __slots__ = ("status", "headers", "data")

    def __init__(self, status: int, headers: http.client.HTTPMessage,
                 data: bytes):
        self.status = status
        self.headers = headers
        self.data = data


class _ConnectionPool:
    """Kept-alive connections to one server, shared by threads.

    ``acquire`` hands out an idle connection (most recently used first) or
    a new one, and never blocks; ``release`` keeps a connection that is
    still open while fewer than ``maxsize`` are idle, and closes it
    otherwise."""

    def __init__(self, host: str, maxsize: int, connection_timeout: float,
                 network_timeout: float):
        self._host = host  # "host[:port]"; http.client parses the port
        self._maxsize = max(1, maxsize)
        self._connection_timeout = connection_timeout
        self._network_timeout = network_timeout
        self._idle: Deque[http.client.HTTPConnection] = deque()
        self._lock = threading.Lock()

    def acquire(self) -> Tuple[http.client.HTTPConnection, bool]:
        """(connection, whether it served a request before)."""
        with self._lock:
            if self._idle:
                return self._idle.pop(), True
        conn = http.client.HTTPConnection(
            self._host, timeout=self._connection_timeout)
        try:
            conn.connect()
            conn.sock.settimeout(self._network_timeout)
        except BaseException:
            conn.close()
            raise
        return conn, False

    def release(self, conn: http.client.HTTPConnection) -> None:
        if conn.sock is not None:  # the server did not ask to close it
            with self._lock:
                if len(self._idle) < self._maxsize:
                    self._idle.append(conn)
                    return
        conn.close()

    def clear(self) -> None:
        with self._lock:
            idle, self._idle = list(self._idle), deque()
        for conn in idle:
            conn.close()

    def request(self, method: str, uri: str, body: Optional[bytes],
                headers: dict, timeout: Optional[float] = None) -> _Response:
        """One request on a pooled connection, its response read whole.
        A request that failed on a reused connection before any response
        byte arrived is sent again on the next one (a stale kept-alive
        connection); each such attempt drops a connection, so the loop ends
        at a new connection, whose failure is raised.  ``timeout``: the
        socket timeout of this request in place of the pool's."""
        while True:
            conn, reused = self.acquire()
            try:
                if timeout is not None:
                    conn.sock.settimeout(timeout)
                try:
                    conn.request(method, uri, body=body, headers=headers)
                    # wait for the response's first byte without taking it
                    arrived = conn.sock.recv(1, socket.MSG_PEEK)
                except ConnectionError:
                    if not reused:
                        raise
                    arrived = b""
                if not arrived:
                    if reused:
                        conn.close()
                        continue
                    raise http.client.RemoteDisconnected(
                        "Remote end closed connection without response")
                resp = conn.getresponse()
                data = resp.read()
                if timeout is not None:
                    conn.sock.settimeout(self._network_timeout)
            except BaseException:
                conn.close()
                raise
            self.release(conn)
            return _Response(resp.status, resp.headers, data)


class PreparedRequest:
    """A compiled :class:`RequestTemplate` bound to a client (the wire fast
    path).  ``infer()`` stamps only the request id and the raw tensor
    bytes: change the data with ``set_data_from_numpy`` on the same
    ``InferInput`` objects that were given to ``prepare()``.  One handle
    per thread: a thread that changes inputs while another infers through
    the same handle tears requests (the template itself is shareable)."""

    def __init__(self, client, template: RequestTemplate):
        self._client = client
        self.template = template
        self.infer_path = _model_path(template.model_name,
                                      template.model_version) + "/infer"

    def infer(self, request_id="", headers=None, query_params=None,
              tenant=None, retry_policy=None,
              deadline_s: Optional[float] = None) -> InferResult:
        """Fast-path inference, with ``client.infer``'s contract (a retry
        stamps the deadline header anew)."""
        client = self._client
        return client._with_policy(
            retry_policy, deadline_s, self.template.model_name, request_id,
            "infer", lambda remaining: client._infer_prepared(
                self, request_id, headers, query_params, tenant, remaining))


class InferAsyncRequest:
    """Handle of an in-flight ``async_infer``."""

    def __init__(self, future: Future, verbose: bool = False):
        self._future = future
        self._verbose = verbose

    def get_result(self, block: bool = True,
                   timeout: Optional[float] = None) -> InferResult:
        """The InferResult, once the response is in (waiting by default);
        raises InferenceServerException on an error, with status
        ``StatusCode.DEADLINE_EXCEEDED`` on a timeout."""
        try:
            return self._future.result(timeout=timeout if block else 0)
        except InferenceServerException:
            raise
        except (TimeoutError, FuturesTimeoutError):
            raise InferenceServerException(
                msg="timed out waiting for inference response",
                status="StatusCode.DEADLINE_EXCEEDED") from None
        except Exception as e:  # noqa: BLE001 - the documented error type
            raise_error(f"failed to obtain inference response: {e}")

    def cancel(self) -> bool:
        return self._future.cancel()


def _model_path(model_name: str, model_version: str) -> str:
    path = f"v2/models/{quote(model_name)}"
    if model_version:
        path += f"/versions/{model_version}"
    return path


class InferenceServerClient(InferenceServerClientBase):
    """Client of the v2 protocol over HTTP/REST.

    Its pool and its calls are thread-safe: up to ``concurrency`` requests
    (``async_infer`` included) run at once, each on its own kept-alive
    connection."""

    def __init__(self, url: str, verbose: bool = False, concurrency: int = 1,
                 connection_timeout: float = 60.0,
                 network_timeout: float = 60.0,
                 max_greenlets: Optional[int] = None,  # API compatibility
                 ssl: bool = False, ssl_options: Optional[dict] = None,
                 ssl_context_factory=None,  # API compatibility
                 insecure: bool = False, retry_policy=None):
        super().__init__()
        if ssl:
            _not_ported("TLS (ssl=True)", "A3b")
        if url.startswith("http://") or url.startswith("https://"):
            raise_error("url should not include the scheme")
        self._url = url
        self._verbose = verbose
        self._concurrency = max(1, concurrency)
        # "host[:port][/base path]"
        host, _, base = url.partition("/")
        self._base_path = "/" + base.rstrip("/") if base.strip("/") else ""
        self._pool = _ConnectionPool(host, self._concurrency,
                                     connection_timeout, network_timeout)
        self._executor: Optional[ThreadPoolExecutor] = None
        self._executor_lock = threading.Lock()
        # the client's default policy: health and metadata calls retry
        # under it, infer where it opts in (a call's retry_policy wins)
        self._retry_policy = retry_policy

    @property
    def url(self) -> str:
        """The ``host:port`` this client talks to."""
        return self._url

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
            retry_meta=(model_name, "http", method_name, request_id))

    def _with_retry(self, method_kind: str, fn):
        """An idempotent (health or metadata) call under the client's
        policy, where it has one."""
        if self._retry_policy is None:
            return fn(None)
        return call_with_retry(
            self._retry_policy, lambda remaining, _attempt: fn(remaining),
            method=method_kind, retry_meta=("", "http", method_kind, ""))

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """Close the client: waits for in-flight async requests, then closes
        every pooled connection."""
        with self._executor_lock:
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
    def _build_headers(self, headers: Optional[dict]) -> dict:
        request = Request(dict(headers) if headers else {})
        self._call_plugin(request)
        bad = [k for k in request.headers if k.lower() == "transfer-encoding"]
        if bad:
            raise_error(f"Unsupported headers {bad}; use a different client "
                        "or remove them.")
        return request.headers

    def _uri(self, path: str, query_params: Optional[dict]) -> str:
        uri = f"{self._base_path}/{path}"
        if query_params:
            uri += "?" + urlencode(query_params, doseq=True)
        return uri

    def _get(self, path: str, headers: Optional[dict],
             query_params: Optional[dict],
             timeout_s: Optional[float] = None) -> _Response:
        uri = self._uri(path, query_params)
        if self._verbose:
            print(f"GET {uri}, headers {headers}")
        response = self._pool.request("GET", uri, None,
                                      self._build_headers(headers),
                                      timeout=timeout_s)
        if self._verbose:
            print(response.status)
        return response

    def _post(self, path: str, body: bytes, headers: Optional[dict],
              query_params: Optional[dict],
              extra_headers: Optional[dict] = None,
              timeout_s: Optional[float] = None) -> _Response:
        uri = self._uri(path, query_params)
        hdrs = self._build_headers(headers)
        if extra_headers:
            hdrs.update(extra_headers)
        if self._verbose:
            print(f"POST {uri}, headers {hdrs}\n{body[:256]!r}")
        response = self._pool.request("POST", uri, body, hdrs,
                                      timeout=timeout_s)
        if self._verbose:
            print(response.status)
        return response

    def _get_json(self, path: str, headers, query_params):
        def call(remaining):
            response = self._get(path, headers, query_params,
                                 timeout_s=remaining)
            raise_if_error(response.status, response.data,
                           response.headers)
            return response

        return json.loads(self._with_retry("metadata", call).data)

    def _post_checked(self, path: str, body: bytes, headers,
                      query_params) -> None:
        response = self._post(path, body, headers, query_params)
        raise_if_error(response.status, response.data)

    # -- health / metadata -------------------------------------------------
    # health probes answer with a bool: any status but 200 is False, as in
    # the reference, so they call no raise_if_error
    def _health(self, path: str, headers, query_params) -> bool:
        """Under a client-level policy a 429 or 503 is retried, and reads
        False once the retries are spent."""
        def call(remaining):
            response = self._get(path, headers, query_params,
                                 timeout_s=remaining)
            if self._retry_policy is not None \
                    and response.status in (429, 503):
                raise_if_error(response.status, response.data,
                               response.headers)
            return response

        try:
            response = self._with_retry("health", call)
        except InferenceServerException as e:
            if normalized_status(e) in ("429", "503"):
                return False  # still overloaded after every retry
            raise
        return response.status == 200

    # tpu-lint: disable=EXC-CONTRACT a health probe answers False on an error status, as in the reference
    def is_server_live(self, headers=None, query_params=None) -> bool:
        return self._health("v2/health/live", headers, query_params)

    # tpu-lint: disable=EXC-CONTRACT a health probe answers False on an error status, as in the reference
    def is_server_ready(self, headers=None, query_params=None) -> bool:
        return self._health("v2/health/ready", headers, query_params)

    # tpu-lint: disable=EXC-CONTRACT a health probe answers False on an error status, as in the reference
    def is_model_ready(self, model_name, model_version="", headers=None,
                       query_params=None) -> bool:
        return self._health(
            _model_path(model_name, model_version) + "/ready", headers,
            query_params)

    def get_server_metadata(self, headers=None, query_params=None) -> dict:
        return self._get_json("v2", headers, query_params)

    def get_model_metadata(self, model_name, model_version="", headers=None,
                           query_params=None) -> dict:
        return self._get_json(_model_path(model_name, model_version),
                              headers, query_params)

    def get_model_config(self, model_name, model_version="", headers=None,
                         query_params=None) -> dict:
        return self._get_json(
            _model_path(model_name, model_version) + "/config", headers,
            query_params)

    def get_inference_statistics(self, model_name="", model_version="",
                                 headers=None, query_params=None) -> dict:
        """The v2 statistics of one model, or of every model."""
        path = "v2/models"
        if model_name:
            path = _model_path(model_name, model_version)
        return self._get_json(path + "/stats", headers, query_params)

    # -- trace and log settings, debug snapshots ---------------------------
    def update_trace_settings(self, model_name=None,
                              settings: Optional[dict] = None, headers=None,
                              query_params=None) -> dict:
        """Set the server's trace settings (a model's where
        ``model_name``); a ``None`` value clears a key.  Returns the
        settings now in force."""
        path = (f"v2/models/{quote(model_name)}/trace/setting" if model_name
                else "v2/trace/setting")
        response = self._post(path, json.dumps(settings or {}).encode(),
                              headers, query_params)
        raise_if_error(response.status, response.data)
        return json.loads(response.data)

    def get_trace_settings(self, model_name=None, headers=None,
                           query_params=None) -> dict:
        path = (f"v2/models/{quote(model_name)}/trace/setting" if model_name
                else "v2/trace/setting")
        return self._get_json(path, headers, query_params)

    def update_log_settings(self, settings: dict, headers=None,
                            query_params=None) -> dict:
        response = self._post("v2/logging", json.dumps(settings).encode(),
                              headers, query_params)
        raise_if_error(response.status, response.data)
        return json.loads(response.data)

    def get_log_settings(self, headers=None, query_params=None) -> dict:
        return self._get_json("v2/logging", headers, query_params)

    def get_flight_recorder(self, model_name=None, limit=0, headers=None,
                            query_params=None) -> dict:
        """The flight recorder's snapshot: the recent ring and the pinned
        outliers with their span trees."""
        params = dict(query_params or {})
        if model_name:
            params["model"] = model_name
        if limit:
            params["limit"] = limit
        return self._get_json("v2/debug/flight_recorder", headers,
                              params or None)

    def get_device_stats(self, model_name=None, headers=None,
                         query_params=None) -> dict:
        """The device statistics: per-model duty cycle, live MFU and
        signature events, batcher ticks, transfers, device memory, and the
        SLO state under ``"slo"``."""
        params = dict(query_params or {})
        if model_name:
            params["model"] = model_name
        return self._get_json("v2/debug/device_stats", headers,
                              params or None)

    def get_costs(self, model_name=None, headers=None,
                  query_params=None) -> dict:
        """The cost ledger: device time and FLOPs per (model, tenant)."""
        params = dict(query_params or {})
        if model_name:
            params["model"] = model_name
        return self._get_json("v2/debug/costs", headers, params or None)

    # -- shared memory -----------------------------------------------------
    def get_system_shared_memory_status(self, region_name="", headers=None,
                                        query_params=None) -> list:
        path = "v2/systemsharedmemory"
        if region_name:
            path += f"/region/{quote(region_name)}"
        return self._get_json(f"{path}/status", headers, query_params)

    def register_system_shared_memory(self, name, key, byte_size, offset=0,
                                      headers=None,
                                      query_params=None) -> None:
        body = {"key": key, "offset": offset, "byte_size": byte_size}
        self._post_checked(
            f"v2/systemsharedmemory/region/{quote(name)}/register",
            json.dumps(body).encode(), headers, query_params)

    def unregister_system_shared_memory(self, name="", headers=None,
                                        query_params=None) -> None:
        path = (f"v2/systemsharedmemory/region/{quote(name)}/unregister"
                if name else "v2/systemsharedmemory/unregister")
        self._post_checked(path, b"", headers, query_params)

    def get_cuda_shared_memory_status(self, region_name="", headers=None,
                                      query_params=None) -> list:
        path = "v2/cudasharedmemory"
        if region_name:
            path += f"/region/{quote(region_name)}"
        return self._get_json(f"{path}/status", headers, query_params)

    def register_cuda_shared_memory(self, name, raw_handle: bytes,
                                    device_id: int, byte_size: int,
                                    headers=None, query_params=None) -> None:
        """Register a CUDA region; ``raw_handle`` is
        ``cuda_shared_memory.get_raw_handle``'s, sent base64-encoded."""
        import base64

        body = {"raw_handle": {"b64": base64.b64encode(raw_handle).decode()},
                "device_id": device_id, "byte_size": byte_size}
        self._post_checked(
            f"v2/cudasharedmemory/region/{quote(name)}/register",
            json.dumps(body).encode(), headers, query_params)

    def unregister_cuda_shared_memory(self, name="", headers=None,
                                      query_params=None) -> None:
        path = (f"v2/cudasharedmemory/region/{quote(name)}/unregister"
                if name else "v2/cudasharedmemory/unregister")
        self._post_checked(path, b"", headers, query_params)

    # -- inference ---------------------------------------------------------
    @staticmethod
    def generate_request_body(inputs, outputs=None, request_id="",
                              sequence_id=0, sequence_start=False,
                              sequence_end=False, priority=0, timeout=None,
                              parameters=None):
        """(body, json_size) of an infer request, for store-and-forward
        use."""
        return get_inference_request_body(
            inputs, request_id, outputs, sequence_id, sequence_start,
            sequence_end, priority, timeout, parameters)

    @staticmethod
    def parse_response_body(response_body, verbose=False, header_length=None,
                            content_encoding=None) -> InferResult:
        """An InferResult from a stored response body."""
        return InferResult.from_response_body(
            response_body, verbose, header_length, content_encoding)

    def _send_infer(self, path: str, body: bytes, json_size: Optional[int],
                    headers, query_params, extra_headers: Dict[str, str],
                    tenant: Optional[str] = None,
                    remaining_s: Optional[float] = None) -> InferResult:
        """One attempt: ``tenant`` in ``triton-tenant``, what is left of the
        deadline in ``triton-timeout-us`` and as the socket timeout."""
        if json_size is not None:
            extra_headers["Inference-Header-Content-Length"] = str(json_size)
        if tenant:
            extra_headers["triton-tenant"] = str(tenant)
        if remaining_s is not None:
            extra_headers["triton-timeout-us"] = str(
                remaining_us(remaining_s))
        response = self._post(
            path, body, headers, query_params, extra_headers,
            timeout_s=min_timeout(None, remaining_s))
        raise_if_error(response.status, response.data, response.headers)
        header_length = response.headers.get(
            "Inference-Header-Content-Length")
        return InferResult(
            response.data, self._verbose,
            int(header_length) if header_length is not None else None,
            response.headers.get("Content-Encoding"),
            headers=response.headers)

    def _infer_request(self, model_name, inputs, model_version, outputs,
                       request_id, sequence_id, sequence_start, sequence_end,
                       priority, timeout, headers, query_params,
                       request_compression_algorithm,
                       response_compression_algorithm,
                       parameters, tenant=None,
                       remaining_s=None) -> InferResult:
        body, json_size = get_inference_request_body(
            inputs, request_id, outputs, sequence_id, sequence_start,
            sequence_end, priority, timeout, parameters)
        extra_headers = {}
        if request_compression_algorithm == "gzip":
            body = gzip.compress(body)
            extra_headers["Content-Encoding"] = "gzip"
        elif request_compression_algorithm == "deflate":
            body = zlib.compress(body)
            extra_headers["Content-Encoding"] = "deflate"
        if response_compression_algorithm in ("gzip", "deflate"):
            extra_headers["Accept-Encoding"] = response_compression_algorithm
        return self._send_infer(
            _model_path(model_name, model_version) + "/infer", body,
            json_size, headers, query_params, extra_headers, tenant,
            remaining_s)

    def prepare(self, model_name, inputs, model_version="", outputs=None,
                priority=0, timeout=None, parameters=None) -> PreparedRequest:
        """Compile the fixed part of a request once (see ``_template.py``);
        the handle's ``infer()`` stamps only the id and the tensor bytes.
        ``inputs`` must carry binary data already; changing their shape,
        dtype or representation, or the outputs, afterwards makes ``infer``
        raise (prepare again)."""
        return PreparedRequest(self, RequestTemplate(
            model_name, inputs, outputs, model_version, priority, timeout,
            parameters))

    def _infer_prepared(self, prep: PreparedRequest, request_id, headers,
                        query_params, tenant=None,
                        remaining_s=None) -> InferResult:
        body, json_size = prep.template.stamp(request_id)
        return self._send_infer(prep.infer_path, body, json_size, headers,
                                query_params, {}, tenant, remaining_s)

    def infer(self, model_name, inputs, model_version="", outputs=None,
              request_id="", sequence_id=0, sequence_start=False,
              sequence_end=False, priority=0, timeout=None, headers=None,
              query_params=None, request_compression_algorithm=None,
              response_compression_algorithm=None, parameters=None,
              retry_policy=None, deadline_s: Optional[float] = None,
              tenant: Optional[str] = None) -> InferResult:
        """Run one inference and wait for its result.  ``retry_policy``
        (else the client's) retries retryable failures where it opts in to
        ``retry_infer``; ``deadline_s`` caps the time across attempts and
        travels to the server in ``triton-timeout-us``; ``priority`` (0 =
        highest) and ``tenant`` are the QoS identity, sent on every
        attempt."""
        return self._with_policy(
            retry_policy, deadline_s, model_name, request_id, "infer",
            lambda remaining: self._infer_request(
                model_name, inputs, model_version, outputs, request_id,
                sequence_id, sequence_start, sequence_end, priority,
                timeout, headers, query_params,
                request_compression_algorithm,
                response_compression_algorithm, parameters, tenant,
                remaining))

    def async_infer(self, model_name, inputs, model_version="", outputs=None,
                    request_id="", sequence_id=0, sequence_start=False,
                    sequence_end=False, priority=0, timeout=None,
                    headers=None, query_params=None,
                    request_compression_algorithm=None,
                    response_compression_algorithm=None, parameters=None,
                    retry_policy=None, deadline_s: Optional[float] = None,
                    tenant: Optional[str] = None) -> InferAsyncRequest:
        """Submit an inference to the client's pool of ``concurrency``
        threads and return its handle; retries and the deadline, as
        ``infer``'s, run on the pool's thread."""
        # the body is gathered on a worker after this returns: copy views
        # of the caller's arrays now
        for inp in inputs:
            inp._freeze_raw()

        def task():
            return self._with_policy(
                retry_policy, deadline_s, model_name, request_id,
                "async_infer", lambda remaining: self._infer_request(
                    model_name, inputs, model_version, outputs, request_id,
                    sequence_id, sequence_start, sequence_end, priority,
                    timeout, headers, query_params,
                    request_compression_algorithm,
                    response_compression_algorithm, parameters, tenant,
                    remaining))

        with self._executor_lock:
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=self._concurrency,
                    thread_name_prefix="tc-torch-http")
            future = self._executor.submit(task)
        return InferAsyncRequest(future, self._verbose)
