"""asyncio ``ClusterClient``: the routing layer over the port's aio
clients.

Counterpart of ``triton_client_tpu/cluster/aio.py``: the sync
:class:`ClusterClient`'s pool, policies, breakers and hedging over
``http.aio`` / ``grpc.aio`` clients in one event loop.  Hedging runs the
primary and the backup as asyncio tasks (``asyncio.wait``,
``FIRST_COMPLETED``) and cancels the loser, whose connection closes (a
cancelled aio request never goes back to its pool); active probing is an
asyncio task (``start_probing``, or ``health_interval_s``, started at the
first routed call).  After ``close()`` a lazily made endpoint client
raises instead of being built into a dict nobody closes.  The protocol
labels of its telemetry are ``http_aio`` / ``grpc_aio``.
"""

from __future__ import annotations

import asyncio
import time
from functools import partial
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

from .._client import InferenceServerClientBase
from .._resilience import RetryPolicy, call_with_retry_async
from .._telemetry import telemetry
from ..utils import raise_error
from ._client import (_BROADCAST_METHODS, _HEALTH_METHODS,
                      _METADATA_METHODS, _STREAMING_METHODS,
                      merge_cost_snapshots)
from ._policy import HedgePolicy
from ._pool import Endpoint, EndpointPool

__all__ = ["ClusterClient"]


class ClusterClient(InferenceServerClientBase):
    """v2 client over a fleet of endpoints (asyncio; http or grpc): the
    sync ``ClusterClient``'s constructor, every public method ``async``."""

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
        on_route: Optional[Callable[[str, str, int], None]] = None,
    ):
        super().__init__()
        protocol = protocol.lower()
        if protocol not in ("http", "grpc"):
            raise_error(f"protocol must be 'http' or 'grpc', got {protocol}")
        self._protocol_label = protocol + "_aio"
        self._protocol = protocol
        self._pool = EndpointPool(urls, policy=policy,
                                  failure_threshold=failure_threshold,
                                  reset_timeout_s=reset_timeout_s)
        self._retry_policy = retry_policy
        self._hedge = hedge
        self._on_route = on_route
        self._client_kwargs = dict(client_kwargs or {})
        self._client_factory = client_factory
        self._clients: Dict[str, Any] = {}
        self._closed = False
        self._probe_task: Optional[asyncio.Task] = None
        # deferred: the constructor may run outside any event loop, so the
        # probe task starts lazily on the first routed call instead
        self._health_interval_s = health_interval_s

    # -- wiring ------------------------------------------------------------
    @property
    def pool(self) -> EndpointPool:
        return self._pool

    @property
    def urls(self) -> List[str]:
        return self._pool.urls

    def _make_client(self, url: str):
        if self._client_factory is not None:
            return self._client_factory(url)
        if self._protocol == "grpc":
            from ..grpc import aio as mod
        else:
            from ..http import aio as mod
        return mod.InferenceServerClient(url, **self._client_kwargs)

    def _client_for(self, ep: Endpoint):
        client = self._clients.get(ep.url)
        if client is None:
            if self._closed:
                # a task resuming after close() must not build a client
                # into a dict nobody will ever close (the sync client's
                # contract)
                raise_error("client is closed")
            client = self._make_client(ep.url)
            if self._plugin is not None:
                client.register_plugin(self._plugin)
            self._clients[ep.url] = client
        return client

    # plugin fan-out: same contract as the sync cluster client — a
    # registered plugin must reach every per-endpoint client's requests
    def register_plugin(self, plugin) -> None:
        super().register_plugin(plugin)
        for c in self._clients.values():
            c.register_plugin(plugin)

    def unregister_plugin(self) -> None:
        super().unregister_plugin()
        for c in self._clients.values():
            if c.plugin() is not None:
                c.unregister_plugin()

    async def close(self) -> None:
        self._closed = True
        if self._probe_task is not None:
            self._probe_task.cancel()
            try:
                await self._probe_task
            except (asyncio.CancelledError, Exception):
                pass
            self._probe_task = None
        clients, self._clients = dict(self._clients), {}
        for c in clients.values():
            try:
                await c.close()
            except Exception:
                pass

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        await self.close()

    # -- active health probing ---------------------------------------------
    async def probe_all(self, timeout_s: float = 2.0) -> Dict[str, bool]:
        """One readiness sweep, all endpoints probed concurrently (a
        sweep costs ~one ``timeout_s`` regardless of how many replicas
        are dead); verdicts feed the breakers."""
        async def probe_one(ep: Endpoint) -> bool:
            try:
                client = self._client_for(ep)
                if self._protocol == "grpc":
                    return bool(await client.is_server_ready(
                        client_timeout=timeout_s))
                return bool(await asyncio.wait_for(
                    client.is_server_ready(), timeout=timeout_s))
            except Exception:
                return False

        results = await asyncio.gather(
            *(probe_one(ep) for ep in self._pool.endpoints))
        verdicts = {}
        for ep, ok in zip(self._pool.endpoints, results):
            verdicts[ep.url] = ok
            self._pool.probe_ok(ep.url, ok)
        return verdicts

    def _maybe_start_probing(self) -> None:
        if self._health_interval_s is not None and self._probe_task is None:
            self.start_probing(self._health_interval_s)

    def start_probing(self, interval_s: float) -> None:
        if self._probe_task is not None:
            return

        async def _loop():
            while True:
                await asyncio.sleep(interval_s)
                try:
                    await self.probe_all()
                except Exception:
                    pass

        self._probe_task = asyncio.ensure_future(_loop())

    # -- routed single calls -----------------------------------------------
    async def _routed(self, kind: str, name: str, *args, **kwargs):
        self._maybe_start_probing()
        policy = self._retry_policy
        excluded: List[str] = []
        last: List[Optional[Endpoint]] = [None]

        async def attempt(_remaining, _n):
            ep = self._pool.pick(exclude=excluded)
            last[0] = ep
            client = self._client_for(ep)
            ep.acquire()
            try:
                result = await getattr(client, name)(*args, **kwargs)
            except Exception:
                self._pool.record(ep, ok=False)
                raise
            finally:
                ep.release()
            self._pool.record(ep, ok=True)
            return result

        if policy is None:
            return await attempt(None, 1)

        def on_failure(_exc, _n):
            if last[0] is not None:
                excluded.append(last[0].url)

        return await call_with_retry_async(
            policy, attempt, method=kind,
            retry_meta=("", self._protocol_label, kind, ""),
            on_failure=on_failure)

    async def _broadcast(self, name: str, *args, **kwargs):
        """Control-plane call applied to every endpoint (see the sync
        client); first failure re-raised after all were attempted."""
        first_result = _UNSET = object()
        first_error: Optional[BaseException] = None
        for ep in self._pool.endpoints:
            try:
                result = await getattr(
                    self._client_for(ep), name)(*args, **kwargs)
                if first_result is _UNSET:
                    first_result = result
            except Exception as e:  # noqa: BLE001 — collected, re-raised
                if first_error is None:
                    first_error = e
        if first_error is not None:
            raise first_error
        return None if first_result is _UNSET else first_result

    async def get_costs(self, model_name=None, **kwargs) -> dict:
        """Fleet-wide per-tenant cost attribution: every endpoint's
        ``/v2/debug/costs`` ledger, summed per (model, tenant) — the
        async mirror of the sync cluster client's fan-out."""
        snaps: List[dict] = []
        first_error: Optional[BaseException] = None
        for ep in self._pool.endpoints:
            try:
                snaps.append(await self._client_for(ep).get_costs(
                    model_name=model_name, **kwargs))
            except Exception as e:  # noqa: BLE001 — collected, re-raised
                if first_error is None:
                    first_error = e
        if first_error is not None:
            raise first_error
        return merge_cost_snapshots(snaps)

    def __getattr__(self, name: str):
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

    # -- inference ---------------------------------------------------------
    async def infer(
        self,
        model_name: str,
        inputs,
        model_version: str = "",
        outputs=None,
        request_id: str = "",
        sequence_id: int = 0,
        sequence_start: bool = False,
        sequence_end: bool = False,
        priority: int = 0,
        timeout=None,
        headers=None,
        parameters=None,
        retry_policy: Optional[RetryPolicy] = None,
        deadline_s: Optional[float] = None,
        hedge: Optional[bool] = None,
        tenant: Optional[str] = None,
        **kwargs,
    ):
        """Routed inference — same contract as the sync cluster client
        (``priority``/``tenant`` ride the per-attempt call dict, so
        retries and hedged backups re-stamp the QoS identity)."""
        self._maybe_start_probing()
        policy = retry_policy if retry_policy is not None \
            else self._retry_policy
        call = dict(
            inputs=inputs, model_version=model_version, outputs=outputs,
            request_id=request_id, sequence_id=sequence_id,
            sequence_start=sequence_start, sequence_end=sequence_end,
            priority=priority, timeout=timeout, headers=headers,
            parameters=parameters, tenant=tenant, **kwargs)
        hedging = self._hedge_armed(policy, hedge, sequence_id)
        excluded: List[str] = []
        last: List[Optional[Endpoint]] = [None]

        async def attempt(remaining, _n):
            prev = last[0]
            ep = self._pool.pick(sequence_id=sequence_id, exclude=excluded)
            last[0] = ep
            if prev is not None and ep.url != prev.url:
                # cross-replica hop: journey event, as in the sync client
                telemetry().record_journey_event(
                    "ENDPOINT_SWITCH", model_name, self._protocol_label,
                    endpoint=ep.url, request_id=request_id)
            if self._on_route is not None:
                self._on_route(ep.url, model_name, sequence_id)
            if hedging:
                return await self._hedged_infer(
                    ep, remaining, excluded, model_name, request_id, call)
            return await self._infer_on(ep, remaining, model_name, call)

        if policy is None and deadline_s is None:
            return await attempt(None, 1)

        def on_failure(_exc, _n):
            if last[0] is not None:
                excluded.append(last[0].url)

        return await call_with_retry_async(
            policy, attempt, method="infer", deadline_s=deadline_s,
            retry_meta=(model_name, self._protocol_label, "infer",
                        request_id),
            on_failure=on_failure, journey=True)

    async def infer_many(
        self,
        model_name: str,
        requests,
        retry_policy: Optional[RetryPolicy] = None,
        deadline_s: Optional[float] = None,
        **kwargs,
    ):
        """Routed batch submit — the sync cluster client's contract over
        the aio endpoint clients (whole flight to one endpoint; a retry
        replays the flight on another replica, gated on ``retry_infer``;
        no hedging)."""
        items = list(requests)
        if not items:
            return []
        self._maybe_start_probing()
        policy = retry_policy if retry_policy is not None \
            else self._retry_policy
        excluded: List[str] = []
        last: List[Optional[Endpoint]] = [None]

        call = dict(requests=items, **kwargs)

        async def attempt(remaining, _n):
            ep = self._pool.pick(exclude=excluded)
            last[0] = ep
            if self._on_route is not None:
                self._on_route(ep.url, model_name, 0)
            return await self._infer_on(ep, remaining, model_name, call,
                                        method="infer_many")

        if policy is None and deadline_s is None:
            return await attempt(None, 1)

        def on_failure(_exc, _n):
            if last[0] is not None:
                excluded.append(last[0].url)

        return await call_with_retry_async(
            policy, attempt, method="infer", deadline_s=deadline_s,
            retry_meta=(model_name, self._protocol_label, "infer", ""),
            on_failure=on_failure)

    def _hedge_armed(self, policy: Optional[RetryPolicy],
                     hedge_override: Optional[bool],
                     sequence_id: int) -> bool:
        if self._hedge is None or len(self._pool.endpoints) < 2:
            return False
        if sequence_id:
            return False
        if hedge_override is not None:
            return hedge_override
        return policy is not None and policy.retry_infer

    async def _infer_on(self, ep: Endpoint, remaining_s: Optional[float],
                        model_name: str, call: Dict[str, Any],
                        method: str = "infer"):
        """``method`` selects the endpoint-client entry point (``infer`` /
        ``infer_many``) so batch flights share this bookkeeping (see the
        sync client)."""
        client = self._client_for(ep)
        ep.acquire()
        t0 = time.perf_counter()
        try:
            result = await getattr(client, method)(
                model_name, retry_policy=None, deadline_s=remaining_s,
                **call)
        except Exception:
            self._pool.record(ep, ok=False)
            raise
        finally:
            ep.release()
        ep.observe(model_name, time.perf_counter() - t0)
        self._pool.record(ep, ok=True)
        return result

    async def _hedged_infer(self, primary: Endpoint,
                            remaining_s: Optional[float],
                            excluded: List[str], model_name: str,
                            request_id: str, call: Dict[str, Any]):
        """A hedged attempt over asyncio tasks: the loser is cancelled, and
        its in-flight request's connection closed."""
        tel = telemetry()
        delay = self._hedge.delay_s(primary, model_name)
        if remaining_s is not None:
            delay = min(delay, max(remaining_s * 0.5, 0.0))
        t0 = time.monotonic()
        t0_ns = time.monotonic_ns()
        t_primary = asyncio.ensure_future(
            self._infer_on(primary, remaining_s, model_name, call))
        done, _ = await asyncio.wait({t_primary}, timeout=delay)
        if t_primary in done:
            return t_primary.result()
        backup_ep = self._pool.pick(exclude=list(excluded) + [primary.url])
        if backup_ep.url == primary.url:
            return await t_primary
        tel.record_hedge(model_name, self._protocol_label)
        if self._on_route is not None:
            self._on_route(backup_ep.url, model_name, 0)
        rem2 = remaining_s
        if rem2 is not None:
            rem2 = max(rem2 - (time.monotonic() - t0), 1e-3)
        t_backup = asyncio.ensure_future(
            self._infer_on(backup_ep, rem2, model_name, call))
        pending = {t_primary, t_backup}
        primary_error: Optional[BaseException] = None
        try:
            while pending:
                done, pending = await asyncio.wait(
                    pending, return_when=asyncio.FIRST_COMPLETED)
                for t in done:
                    if not t.cancelled() and t.exception() is None:
                        if t is t_backup:
                            tel.record_hedge(model_name,
                                             self._protocol_label, won=True)
                        if tel.tracing_enabled:
                            tel.record_client_trace(
                                request_id, model_name,
                                self._protocol_label, "hedge",
                                spans=[("HEDGE", t0_ns,
                                        time.monotonic_ns())],
                                endpoint=backup_ep.url)
                        return t.result()
                    if t is t_primary:
                        primary_error = t.exception()
                    else:
                        excluded.append(backup_ep.url)
            raise primary_error if primary_error is not None \
                else t_backup.exception()
        finally:
            for t in (t_primary, t_backup):
                if not t.done():
                    t.cancel()
                    try:
                        await t
                    except (asyncio.CancelledError, Exception):
                        pass
