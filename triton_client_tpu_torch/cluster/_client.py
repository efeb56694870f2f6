"""``ClusterClient``: one client surface over N endpoints (the reference's
``triton_client_tpu/cluster/_client.py``).

It holds one of the port's ``InferenceServerClient`` per endpoint
(``http``, or ``grpc``: gRPC-Web on the server's HTTP port), made at its
first use, and routes over them:

* each ``infer`` takes its endpoint from the :class:`EndpointPool`
  (policy, a sequence's pin, breakers);
* under a :class:`RetryPolicy` each failed attempt's endpoint is excluded
  from the next pick, so a retry lands on another replica where there is
  one (an ``ENDPOINT_SWITCH`` event on the journey), and a quarantine
  refusal (``is_quarantine_error``, a 503 sent before any compute) is
  retried on another replica even where ``retry_infer`` is off; with
  every replica quarantined the caller gets the last refusal;
* hedged requests (:class:`HedgePolicy`): after the hedge delay the same
  request goes to a second endpoint on the client's own executor and the
  first answer wins; the loser runs to its end on its thread, its answer
  dropped, its outcome still fed to its breaker.  Only what may run twice
  is hedged, never a sequence;
* active health probing (``health_interval_s``, :meth:`probe_all`): every
  endpoint's ``/v2/health/ready`` on a timer, fed to the breakers.

Health and metadata calls go to one endpoint (retried on others under the
client's policy); control-plane calls (load, unload, shared-memory
registration, trace and log settings) go to every endpoint;
:meth:`get_costs` sums every endpoint's ``/v2/debug/costs``
(:func:`merge_cost_snapshots`).  Streams belong to one connection and are
refused.  A plugin registered here reaches every endpoint's client.
:meth:`close` stops the prober, shuts down both executors and closes every
client, and nothing is made after it.
"""

from __future__ import annotations

import contextvars
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import wait as _fut_wait
from functools import partial
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

from .._client import InferenceServerClientBase
from .._resilience import RetryPolicy, call_with_retry
from .._telemetry import telemetry
from ..utils import raise_error
from ._policy import HedgePolicy
from ._pool import Endpoint, EndpointPool

__all__ = ["ClusterClient", "merge_cost_snapshots"]

#: read-only calls, retried on another endpoint under the client's policy
_HEALTH_METHODS = frozenset({
    "is_server_live", "is_server_ready", "is_model_ready",
})
_METADATA_METHODS = frozenset({
    "get_server_metadata", "get_model_metadata", "get_model_config",
    "get_model_repository_index", "get_inference_statistics",
    "get_trace_settings", "get_log_settings", "get_flight_recorder",
    "get_device_stats",
    "get_system_shared_memory_status", "get_cuda_shared_memory_status",
})
#: control-plane calls, sent to every endpoint (the first answer returned)
_BROADCAST_METHODS = frozenset({
    "load_model", "unload_model",
    "update_trace_settings", "update_log_settings",
    "register_system_shared_memory", "unregister_system_shared_memory",
    "register_cuda_shared_memory", "unregister_cuda_shared_memory",
})
_STREAMING_METHODS = frozenset({
    "start_stream", "async_stream_infer", "stop_stream", "stream_infer",
})

_COST_KEYS = ("device_us", "flops", "kv_byte_seconds")


def merge_cost_snapshots(snapshots: Iterable[dict]) -> dict:
    """Several replicas' ``/v2/debug/costs`` snapshots summed per (model,
    tenant): ``device_us``, ``flops``, ``kv_byte_seconds`` (rounded to 6
    places, as the reference rounds them) and ``tokens``; ``enabled``
    where any replica's is.  Entries that are not dicts, and values that
    are not numbers, are skipped."""
    merged: Dict[str, Dict[str, Dict[str, float]]] = {}
    enabled = False
    for snap in snapshots:
        if not isinstance(snap, dict):
            continue
        enabled = enabled or bool(snap.get("enabled"))
        models = snap.get("models")
        if not isinstance(models, dict):
            continue
        for model, tenants in models.items():
            if not isinstance(tenants, dict):
                continue
            into = merged.setdefault(model, {})
            for tenant, cell in tenants.items():
                if not isinstance(cell, dict):
                    continue
                dst = into.setdefault(tenant, {
                    "device_us": 0.0, "flops": 0.0, "tokens": 0,
                    "kv_byte_seconds": 0.0})
                for key in _COST_KEYS:
                    try:
                        dst[key] = round(
                            dst[key] + float(cell.get(key, 0.0)), 6)
                    except (TypeError, ValueError):
                        pass
                try:
                    dst["tokens"] += int(cell.get("tokens", 0))
                except (TypeError, ValueError):
                    pass
    return {"enabled": enabled, "models": merged}


class ClusterClient(InferenceServerClientBase):
    """The v2 client over a fleet of endpoints.

    ``urls``: a list, or one comma-separated string.  ``protocol``:
    ``http`` or ``grpc``, the port's client made for each endpoint (with
    ``client_kwargs``, or by ``client_factory(url)``).  ``policy``:
    ``round_robin``, ``least_outstanding`` or a ``BalancingPolicy``; a
    nonzero ``sequence_id`` bypasses it for its rendezvous pin.
    ``retry_policy``: the client's :class:`RetryPolicy` (a call may pass
    its own); a retry prefers another endpoint.  ``hedge``: a
    :class:`HedgePolicy`, or None for no hedging; ``hedge_workers`` bounds
    the hedge executor.  ``health_interval_s``: probe every endpoint this
    often (None: the breakers learn from requests only).
    ``failure_threshold`` and ``reset_timeout_s``: each breaker's.
    ``on_route(url, model, sequence_id)`` is called for every routed
    attempt (hedge backups included)."""

    def __init__(
        self,
        urls: Union[str, Iterable[str]],
        protocol: str = "http",
        policy: Union[str, object] = "least_outstanding",
        retry_policy: Optional[RetryPolicy] = None,
        hedge: Optional[HedgePolicy] = None,
        health_interval_s: Optional[float] = None,
        failure_threshold: int = 3,
        reset_timeout_s: float = 5.0,
        client_kwargs: Optional[Dict[str, Any]] = None,
        client_factory: Optional[Callable[[str], Any]] = None,
        hedge_workers: int = 32,
        on_route: Optional[Callable[[str, str, int], None]] = None,
    ):
        super().__init__()
        protocol = protocol.lower()
        if protocol not in ("http", "grpc"):
            raise_error(f"protocol must be 'http' or 'grpc', got {protocol}")
        self._protocol = protocol
        self._pool = EndpointPool(urls, policy=policy,
                                  failure_threshold=failure_threshold,
                                  reset_timeout_s=reset_timeout_s)
        self._retry_policy = retry_policy
        self._hedge = hedge
        self._hedge_workers = int(hedge_workers)
        self._on_route = on_route
        self._client_kwargs = dict(client_kwargs or {})
        self._client_factory = client_factory
        self._clients: Dict[str, Any] = {}
        self._probe_clients: Dict[str, Any] = {}
        # guards the two client dicts, both executors and _closed
        self._clients_lock = threading.Lock()
        self._executor: Optional[ThreadPoolExecutor] = None
        self._probe_executor: Optional[ThreadPoolExecutor] = None
        self._closed = False
        self._probe_stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None
        if health_interval_s is not None:
            self.start_probing(health_interval_s)

    @property
    def pool(self) -> EndpointPool:
        return self._pool

    @property
    def urls(self) -> List[str]:
        return self._pool.urls

    # -- the endpoints' clients, made at first use ---------------------------
    def _lazy(self, cache: Dict[str, Any], url: str,
              make: Callable[[], Any]):
        """``cache[url]``, made under the lock where missing; after
        ``close`` nothing is made (it would never be closed)."""
        client = cache.get(url)
        if client is None:
            with self._clients_lock:
                if self._closed:
                    raise_error("client is closed")
                client = cache.get(url)
                if client is None:
                    client = make()
                    if self._plugin is not None:
                        client.register_plugin(self._plugin)
                    cache[url] = client
        return client

    def _make_client(self, url: str, **overrides):
        if self._client_factory is not None:
            return self._client_factory(url)
        if self._protocol == "grpc":
            from .. import grpc as mod
        else:
            from .. import http as mod
        return mod.InferenceServerClient(
            url, **{**self._client_kwargs, **overrides})

    def _client_for(self, ep: Endpoint):
        return self._lazy(self._clients, ep.url,
                          lambda: self._make_client(ep.url))

    def _probe_client_for(self, ep: Endpoint, timeout_s: float):
        """The client of one health probe.  An HTTP client's timeouts are
        set when it is made, so HTTP probes get clients of their own with
        ``timeout_s``: a blackholed replica then costs one probe
        ``timeout_s``, not the 60 s default.  gRPC takes a timeout per
        call."""
        if self._protocol == "grpc" or self._client_factory is not None:
            return self._client_for(ep)
        return self._lazy(
            self._probe_clients, ep.url,
            lambda: self._make_client(ep.url, connection_timeout=timeout_s,
                                      network_timeout=timeout_s))

    def _all_clients(self) -> List[Any]:
        with self._clients_lock:
            return (list(self._clients.values())
                    + list(self._probe_clients.values()))

    # a plugin (an auth header, say) must reach every request, and the
    # requests leave through the endpoints' clients: made ones get it
    # here, later ones in _lazy
    def register_plugin(self, plugin) -> None:
        super().register_plugin(plugin)
        for c in self._all_clients():
            c.register_plugin(plugin)

    def unregister_plugin(self) -> None:
        super().unregister_plugin()
        for c in self._all_clients():
            if c.plugin() is not None:
                c.unregister_plugin()

    def close(self) -> None:
        self._probe_stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=10)
            self._probe_thread = None
        # the executors are taken under the lock (they are made under it)
        # and shut down outside it: their tasks take the lock in _lazy
        with self._clients_lock:
            self._closed = True
            executors = [self._executor, self._probe_executor]
            self._executor = self._probe_executor = None
        for ex in executors:
            if ex is not None:
                ex.shutdown(wait=True)
        clients = self._all_clients()
        with self._clients_lock:
            self._clients, self._probe_clients = {}, {}
        for c in clients:
            try:
                c.close()
            except Exception:  # noqa: BLE001 - close the rest
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _lazy_executor(self, attr: str, workers: int, prefix: str
                       ) -> ThreadPoolExecutor:
        """The executor in ``self.<attr>``, made once under the lock (two
        first users must not make two), never after ``close``."""
        ex = getattr(self, attr)
        if ex is None:
            with self._clients_lock:
                if self._closed:
                    raise_error("client is closed")
                if getattr(self, attr) is None:
                    setattr(self, attr, ThreadPoolExecutor(
                        max_workers=workers, thread_name_prefix=prefix))
                ex = getattr(self, attr)
        return ex

    @staticmethod
    def _submit(ex: ThreadPoolExecutor, fn, *args):
        try:
            # the copied context carries the journey to the pool's thread:
            # every attempt's traceparent shares the journey's trace id
            return ex.submit(contextvars.copy_context().run, fn, *args)
        except RuntimeError:
            # close() shut the executor down since it was read
            raise_error("client is closed")

    # -- active health probing ------------------------------------------------
    def probe_all(self, timeout_s: float = 2.0) -> Dict[str, bool]:
        """Probe every endpoint's readiness at once (one sweep costs about
        one ``timeout_s`` however many replicas hang) and feed each
        verdict to its breaker.  Returns ``{url: ready}``."""
        verdicts: Dict[str, bool] = {}

        def probe_one(ep: Endpoint) -> None:
            try:
                client = self._probe_client_for(ep, timeout_s)
                ok = bool(client.is_server_ready(client_timeout=timeout_s)
                          if self._protocol == "grpc"
                          else client.is_server_ready())
            except Exception:  # noqa: BLE001 - a failed probe
                ok = False
            verdicts[ep.url] = ok
            self._pool.probe_ok(ep.url, ok)

        endpoints = self._pool.endpoints
        if len(endpoints) == 1:
            probe_one(endpoints[0])
            return verdicts
        ex = self._lazy_executor("_probe_executor", len(endpoints),
                                 "tc-torch-probe")
        futures = [self._submit(ex, probe_one, ep) for ep in endpoints]
        _fut_wait(futures, timeout=timeout_s + 5.0)
        return dict(verdicts)

    def start_probing(self, interval_s: float) -> None:
        if self._probe_thread is not None:
            return

        def loop():
            while not self._probe_stop.wait(interval_s):
                try:
                    self.probe_all()
                except Exception:  # noqa: BLE001 - the prober lives on
                    pass

        self._probe_stop.clear()
        self._probe_thread = threading.Thread(
            target=loop, daemon=True, name="tc-torch-cluster-probe")
        self._probe_thread.start()

    # -- routing --------------------------------------------------------------
    def _with_exclusion(self, policy: Optional[RetryPolicy], method: str,
                        retry_meta, attempt_on, sequence_id: int = 0,
                        deadline_s: Optional[float] = None,
                        journey: bool = False, request_id: str = "",
                        model: str = ""):
        """Run ``attempt_on(endpoint, remaining_s, excluded)`` under
        ``policy``: each attempt picks its endpoint with the failed ones
        excluded, and an attempt on another endpoint than the last is an
        ``ENDPOINT_SWITCH`` event (on a journey)."""
        excluded: List[str] = []
        last: List[Optional[Endpoint]] = [None]

        def attempt(remaining, _n):
            prev = last[0]
            ep = self._pool.pick(sequence_id=sequence_id, exclude=excluded)
            last[0] = ep
            if journey and prev is not None and ep.url != prev.url:
                telemetry().record_journey_event(
                    "ENDPOINT_SWITCH", model, self._protocol,
                    endpoint=ep.url, request_id=request_id)
            return attempt_on(ep, remaining, excluded)

        if policy is None and deadline_s is None:
            return attempt(None, 1)

        def on_failure(_exc, _n):
            if last[0] is not None:
                excluded.append(last[0].url)

        return call_with_retry(policy, attempt, method=method,
                               deadline_s=deadline_s, retry_meta=retry_meta,
                               on_failure=on_failure, journey=journey)

    def _call_on(self, ep: Endpoint, name: str, args, kwargs,
                 model: Optional[str] = None):
        """One call on one endpoint: its load counted while it runs, its
        outcome fed to the breaker and the endpoint's counter, and where
        ``model`` is given its latency observed (the hedge delay)."""
        client = self._client_for(ep)
        ep.acquire()
        t0 = time.perf_counter()
        try:
            result = getattr(client, name)(*args, **kwargs)
        except Exception:
            self._pool.record(ep, ok=False)
            raise
        finally:
            ep.release()
        if model is not None:
            ep.observe(model, time.perf_counter() - t0)
        self._pool.record(ep, ok=True)
        return result

    def _routed(self, kind: str, name: str, *args, **kwargs):
        return self._with_exclusion(
            self._retry_policy, kind, ("", self._protocol, kind, ""),
            lambda ep, _rem, _exc: self._call_on(ep, name, args, kwargs))

    def _each_endpoint(self, name: str, *args, **kwargs) -> List[Any]:
        """``name`` called on every endpoint, each one tried; the first
        failure is raised after all were, so one dead replica does not
        leave the others unset."""
        results: List[Any] = []
        first_error: Optional[BaseException] = None
        for ep in self._pool.endpoints:
            try:
                results.append(
                    getattr(self._client_for(ep), name)(*args, **kwargs))
            except Exception as e:  # noqa: BLE001 - raised below
                if first_error is None:
                    first_error = e
        if first_error is not None:
            raise first_error
        return results

    def _broadcast(self, name: str, *args, **kwargs):
        results = self._each_endpoint(name, *args, **kwargs)
        return results[0] if results else None

    def get_costs(self, model_name=None, **kwargs) -> dict:
        """The fleet's cost attribution: every endpoint's
        ``/v2/debug/costs``, summed per (model, tenant).  A replica that
        fails fails the call: a missing one would understate the spend."""
        return merge_cost_snapshots(self._each_endpoint(
            "get_costs", model_name=model_name, **kwargs))

    def __getattr__(self, name: str):
        # reached only where normal lookup fails; private names fail at
        # once (copy and pickle probe them before __init__ ran)
        if name.startswith("_"):
            raise AttributeError(name)
        if name in _HEALTH_METHODS:
            return partial(self._routed, "health", name)
        if name in _METADATA_METHODS:
            return partial(self._routed, "metadata", name)
        if name in _BROADCAST_METHODS:
            return partial(self._broadcast, name)
        if name in _STREAMING_METHODS:
            raise_error(
                f"{name} is per-connection and not supported on "
                "ClusterClient; open a stream on a single-endpoint client")
        raise AttributeError(
            f"{type(self).__name__!s} has no attribute {name!r}")

    # -- inference ------------------------------------------------------------
    def infer(self, model_name: str, inputs, model_version: str = "",
              outputs=None, request_id: str = "", sequence_id: int = 0,
              sequence_start: bool = False, sequence_end: bool = False,
              priority: int = 0, timeout=None, headers=None,
              parameters=None, retry_policy: Optional[RetryPolicy] = None,
              deadline_s: Optional[float] = None,
              hedge: Optional[bool] = None, tenant: Optional[str] = None,
              **kwargs):
        """A routed inference.  ``hedge`` True says the model may run the
        request twice, False turns hedging off for this call; None leaves
        it to the retry policy's ``retry_infer``.  ``priority`` and
        ``tenant`` ride every attempt and backup; other keywords
        (``query_params``, ``client_timeout``, ...) go to the endpoint's
        client."""
        policy = retry_policy if retry_policy is not None \
            else self._retry_policy
        call = dict(
            inputs=inputs, model_version=model_version, outputs=outputs,
            request_id=request_id, sequence_id=sequence_id,
            sequence_start=sequence_start, sequence_end=sequence_end,
            priority=priority, timeout=timeout, headers=headers,
            parameters=parameters, tenant=tenant, **kwargs)
        hedging = self._hedge_armed(policy, hedge, sequence_id)

        def attempt_on(ep, remaining, excluded):
            if self._on_route is not None:
                self._on_route(ep.url, model_name, sequence_id)
            if hedging:
                return self._hedged_infer(ep, remaining, excluded,
                                          model_name, request_id, call)
            return self._infer_on(ep, remaining, model_name, call)

        return self._with_exclusion(
            policy, "infer", (model_name, self._protocol, "infer",
                              request_id), attempt_on,
            sequence_id=sequence_id, deadline_s=deadline_s, journey=True,
            request_id=request_id, model=model_name)

    def infer_many(self, model_name: str, requests,
                   retry_policy: Optional[RetryPolicy] = None,
                   deadline_s: Optional[float] = None, **kwargs):
        """The whole flight to one endpoint (one template, one connection,
        results in order); a retry sends the whole flight again to another
        replica, so the model must tolerate running a request twice.  Not
        hedged."""
        items = list(requests)
        if not items:
            return []
        policy = retry_policy if retry_policy is not None \
            else self._retry_policy
        call = dict(requests=items, **kwargs)

        def attempt_on(ep, remaining, _excluded):
            if self._on_route is not None:
                self._on_route(ep.url, model_name, 0)
            return self._infer_on(ep, remaining, model_name, call,
                                  method="infer_many")

        return self._with_exclusion(
            policy, "infer", (model_name, self._protocol, "infer", ""),
            attempt_on, deadline_s=deadline_s)

    def _hedge_armed(self, policy: Optional[RetryPolicy],
                     override: Optional[bool], sequence_id: int) -> bool:
        if self._hedge is None or len(self._pool.endpoints) < 2:
            return False
        if sequence_id:
            return False  # a sequence's state is on one replica
        if override is not None:
            return override
        # a hedge runs the request again, as a retry does: the same opt-in
        return policy is not None and policy.retry_infer

    def _infer_on(self, ep: Endpoint, remaining_s: Optional[float],
                  model_name: str, call: Dict[str, Any],
                  method: str = "infer"):
        """One attempt on one endpoint, one try there (the cluster owns
        the retries), under what is left of the deadline."""
        return self._call_on(
            ep, method, (model_name,),
            dict(call, retry_policy=None, deadline_s=remaining_s),
            model=model_name)

    def _hedged_infer(self, primary: Endpoint, remaining_s: Optional[float],
                      excluded: List[str], model_name: str, request_id: str,
                      call: Dict[str, Any]):
        """The primary now; after the hedge delay, a backup on another
        endpoint; the first answer wins."""
        tel = telemetry()
        delay = self._hedge.delay_s(primary, model_name)
        if remaining_s is not None:
            # at most half the budget waits for the hedge
            delay = min(delay, max(remaining_s * 0.5, 0.0))
        ex = self._hedge_executor()
        t0 = time.monotonic()
        t0_ns = time.monotonic_ns()
        f_primary = self._submit(ex, self._infer_on, primary, remaining_s,
                                 model_name, call)
        done, _ = _fut_wait([f_primary], timeout=delay)
        if f_primary in done:
            return f_primary.result()
        backup = self._pool.pick(exclude=list(excluded) + [primary.url])
        if backup.url == primary.url:
            return f_primary.result()  # no other replica to hedge to
        tel.record_hedge(model_name, self._protocol)
        if self._on_route is not None:
            self._on_route(backup.url, model_name, 0)
        rem2 = remaining_s
        if rem2 is not None:
            rem2 = max(rem2 - (time.monotonic() - t0), 1e-3)
        f_backup = self._submit(ex, self._infer_on, backup, rem2,
                                model_name, call)
        pending = {f_primary, f_backup}
        primary_error: Optional[BaseException] = None
        while pending:
            done, pending = _fut_wait(pending, return_when=FIRST_COMPLETED)
            for f in done:
                err = f.exception()
                if err is None:
                    if f is f_backup:
                        tel.record_hedge(model_name, self._protocol,
                                         won=True)
                    for loser in pending:
                        # one not started is cancelled; one running ends
                        # on its thread, its answer dropped
                        loser.cancel()
                    if tel.tracing_enabled:
                        tel.record_client_trace(
                            request_id, model_name, self._protocol, "hedge",
                            spans=[("HEDGE", t0_ns, time.monotonic_ns())],
                            endpoint=backup.url)
                    return f.result()
                if f is f_primary:
                    primary_error = err
                else:
                    # the backup's endpoint failed too: the retry excludes
                    # it beside the primary's
                    excluded.append(backup.url)
        raise primary_error if primary_error is not None \
            else f_backup.exception()

    def _hedge_executor(self) -> ThreadPoolExecutor:
        return self._lazy_executor("_executor", self._hedge_workers,
                                   "tc-torch-hedge")
