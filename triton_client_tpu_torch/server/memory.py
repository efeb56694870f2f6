"""Byte-accounted memory admission: the :class:`MemoryGovernor`.

The port's copy of ``triton_client_tpu/server/memory.py``, with the same
ledger, verdicts, texts and export rows.  Three layers:

* **Wire ingress caps** (both frontends of the HTTP port):
  ``--max-request-bytes`` (default :data:`DEFAULT_MAX_REQUEST_BYTES`)
  refuses a request from its declared ``Content-Length`` (or
  ``Inference-Header-Content-Length``) with a 413 before its body is read.
* **Host byte budget** (this class): queued and in-flight request and
  response bytes are held per model and tenant against
  ``--mem-budget-bytes``.  An arrival whose own bytes do not fit its
  tier's share of the live budget (``QosManager.tier_limit``) sheds with a
  429 and pushback, or a 413 where it could never fit.  Response bytes join
  the ledger when the response is built (``add``) and never shed.
* **Device headroom** (:meth:`admit_hbm`): a slot admission that would pin
  more bytes than the safety fraction of the card's headroom is refused
  with a typed 429.  The pin API (``kv_pin``/``cache_pin``) is the KV
  cache's reservation ledger.

The headroom definition is the port's own (:func:`hbm_stats`).  The
reference reads jax's ``bytes_limit - bytes_in_use``, the buffers XLA has
live.  On a CUDA card another process's allocations are invisible to the
caching allocator's counters, so the port takes the card's free bytes
(``torch.cuda.mem_get_info``, which counts every process) plus what the
allocator holds reserved but has not allocated: memory this process can
use without a new allocation from the card.  It never reads more than the
card can give.  Where there
is no card the gate is inert (``None``), as the reference's is on the
CPU.

The ``mem_pressure`` chaos kind (``chaos.py``) shrinks the live budget
for a while through :meth:`inject_pressure`.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .types import InferError

__all__ = ["DEFAULT_MAX_REQUEST_BYTES", "MemoryGovernor", "hbm_stats",
           "oversize_message"]

#: Default wire ingress cap of both frontends: 64 MiB.
#: ``--max-request-bytes 0`` turns it off.
DEFAULT_MAX_REQUEST_BYTES = 64 << 20


def oversize_message(size: int, cap: int) -> str:
    """The ingress cap's refusal text (both protocols)."""
    size_s = f"request of {size} bytes" if size else "request"
    return (f"{size_s} exceeds the server's max request size of {cap} "
            "bytes (--max-request-bytes)")


def hbm_stats() -> Dict[str, Dict[str, int]]:
    """Per CUDA device: ``bytes_limit``, the card's total memory, and
    ``bytes_in_use``, the part of it this process cannot use without
    another process giving memory back, so that ``bytes_limit -
    bytes_in_use`` is the card's free bytes plus the caching allocator's
    reserved-but-unallocated bytes.  Empty where CUDA is not initialized
    (the CPU): the gate is then inert."""
    out: Dict[str, Dict[str, int]] = {}
    try:
        import torch

        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return out
        for i in range(torch.cuda.device_count()):
            free, total = torch.cuda.mem_get_info(i)
            spare = (torch.cuda.memory_reserved(i)
                     - torch.cuda.memory_allocated(i))
            headroom = min(int(total), int(free) + max(0, int(spare)))
            out[f"cuda:{i}"] = {"bytes_limit": int(total),
                                "bytes_in_use": int(total) - headroom}
    except Exception:  # noqa: BLE001 - a gauge failure must not shed
        return {}
    return out


class MemoryGovernor:
    """Byte ledger and admission verdicts for one ``InferenceCore``.

    Thread-safe under one short lock: admission and release run on request
    and batch threads, the metrics renderer snapshots from its own."""

    #: Fraction of the live headroom one admission may claim.
    DEFAULT_HBM_HEADROOM_FRACTION = 0.8

    #: Tenant identity is client-controlled: identities beyond this fold
    #: into ``~overflow``, as in the QoS layer.
    MAX_TRACKED_TENANTS = 1024
    OVERFLOW_TENANT = "~overflow"

    def __init__(self, budget_bytes: int = 0, hbm_stats_fn=None) -> None:
        # host byte budget (0 = unbounded: the ledger tracks, never sheds)
        self.budget_bytes = int(budget_bytes)
        self.hbm_headroom_fraction = self.DEFAULT_HBM_HEADROOM_FRACTION
        # the device-memory source; injectable, so a test can model a full
        # card on the CPU
        self.hbm_stats_fn = hbm_stats_fn if hbm_stats_fn is not None \
            else hbm_stats
        self._lock = threading.Lock()
        self.inflight_bytes = 0
        self.peak_inflight_bytes = 0
        self.inflight_by_model: Dict[str, int] = {}
        self.inflight_by_tenant: Dict[str, int] = {}
        # (model, tenant, tier, reason) -> count; reason "host" = byte
        # budget, "hbm" = device headroom (nv_mem_shed_total labels)
        self.shed: Dict[Tuple[str, str, int, str], int] = {}
        # mem_pressure chaos: the budget reads budget * factor until the
        # window ends (checked lazily, no timer)
        self._pressure_factor = 1.0
        self._pressure_until = 0.0
        self.pressure_events = 0
        self._known_tenants: set = set()
        # pinned KV: handle -> (model, tenant, nbytes, t0)
        self._kv_pins: Dict[int, Tuple[str, str, int, float]] = {}
        self._kv_next_handle = 1
        self._kv_pinned_by_model: Dict[str, int] = {}
        # released byte-seconds per (model, tenant): what a cost ledger's
        # KV byte-seconds must reconcile with
        self.kv_byte_seconds: Dict[Tuple[str, str], float] = {}
        # prefix/KV cache blocks: named pins, apart from the slots' pins
        self._cache_pins: Dict[int, Tuple[str, str, int, float]] = {}
        self._cache_pinned_by_model: Dict[str, int] = {}

    # -- budget ------------------------------------------------------------
    def effective_budget(self, now: Optional[float] = None) -> int:
        """The live host budget: the configured bound scaled by an active
        pressure window (0 = unbounded)."""
        if self.budget_bytes <= 0:
            return 0
        with self._lock:
            return self._effective_budget_locked(
                time.monotonic() if now is None else now)

    def _effective_budget_locked(self, now: float) -> int:
        if self._pressure_factor < 1.0 and now >= self._pressure_until:
            self._pressure_factor = 1.0  # the pressure window lifted
        return max(1, int(self.budget_bytes * self._pressure_factor))

    def _track_tenant_locked(self, tenant: str) -> str:
        if tenant in self._known_tenants:
            return tenant
        if len(self._known_tenants) < self.MAX_TRACKED_TENANTS:
            self._known_tenants.add(tenant)
            return tenant
        return self.OVERFLOW_TENANT

    def inject_pressure(self, factor: float, duration_s: float,
                        now: Optional[float] = None) -> None:
        """Shrink the live budget to ``factor`` of the configured bound for
        ``duration_s``; it restores by itself."""
        factor = min(1.0, max(0.01, float(factor)))
        now = time.monotonic() if now is None else now
        with self._lock:
            self._pressure_factor = factor
            self._pressure_until = now + max(0.0, float(duration_s))
            self.pressure_events += 1

    # -- host-byte admission ----------------------------------------------
    def try_admit(self, model: str, tenant: str, tier: int, nbytes: int,
                  qos=None, base_pushback_s: float = 0.25,
                  now: Optional[float] = None
                  ) -> Optional[Tuple[float, bool]]:
        """The verdict for an arrival of ``nbytes`` wire bytes: ``None`` =
        admitted (the bytes are reserved; pair with :meth:`release`), else
        ``(pushback_s, permanent)``, the shed counted.  ``permanent``: the
        arrival's own bytes exceed its tier's share of the configured
        budget, so no wait admits it (the core answers 413).

        The arrival sheds where the ledger plus its bytes exceed its
        tier's share of the live budget: the largest and lowest-priority
        work is refused first."""
        nbytes = max(0, int(nbytes))
        now = time.monotonic() if now is None else now
        with self._lock:
            tenant = self._track_tenant_locked(tenant)
            budget = (self._effective_budget_locked(now)
                      if self.budget_bytes > 0 else 0)
            if budget > 0:
                tier_budget = (qos.tier_limit(tier, budget)
                               if qos is not None else budget)
                if self.inflight_bytes + nbytes > tier_budget:
                    key = (model, tenant, int(tier), "host")
                    self.shed[key] = self.shed.get(key, 0) + 1
                    configured = (qos.tier_limit(tier, self.budget_bytes)
                                  if qos is not None else self.budget_bytes)
                    permanent = nbytes > configured
                    # pushback scaled by how full the ledger is
                    fill = self.inflight_bytes / float(budget)
                    return (max(0.0, base_pushback_s) * (1.0 + fill),
                            permanent)
            self._reserve_locked(model, tenant, nbytes)
        return None

    def _reserve_locked(self, model: str, tenant: str, nbytes: int) -> None:
        self.inflight_bytes += nbytes
        self.peak_inflight_bytes = max(self.peak_inflight_bytes,
                                       self.inflight_bytes)
        if nbytes:
            self.inflight_by_model[model] = \
                self.inflight_by_model.get(model, 0) + nbytes
            self.inflight_by_tenant[tenant] = \
                self.inflight_by_tenant.get(tenant, 0) + nbytes

    def add(self, model: str, tenant: str, nbytes: int) -> None:
        """Response bytes joining an admitted request's entry (release the
        sum).  Never sheds: the compute is done; the ledger may pass the
        budget for a moment, which ``peak_inflight_bytes`` records."""
        nbytes = max(0, int(nbytes))
        if not nbytes:
            return
        with self._lock:
            self._reserve_locked(model, self._track_tenant_locked(tenant),
                                 nbytes)

    def release(self, model: str, tenant: str, nbytes: int) -> None:
        nbytes = max(0, int(nbytes))
        if not nbytes:
            return
        with self._lock:
            tenant = self._track_tenant_locked(tenant)
            self.inflight_bytes = max(0, self.inflight_bytes - nbytes)
            for d, key in ((self.inflight_by_model, model),
                           (self.inflight_by_tenant, tenant)):
                left = d.get(key, 0) - nbytes
                if left > 0:
                    d[key] = left
                else:
                    d.pop(key, None)

    # -- device headroom ---------------------------------------------------
    def hbm_headroom(self) -> Optional[int]:
        """The least headroom over the devices (:func:`hbm_stats`); None
        where there is no device memory to read: the gate is then inert."""
        try:
            stats = self.hbm_stats_fn() or {}
        except Exception:  # noqa: BLE001 - a gauge failure must not shed
            return None
        headrooms = [s["bytes_limit"] - s.get("bytes_in_use", 0)
                     for s in stats.values() if "bytes_limit" in s]
        if not headrooms:
            return None
        return max(0, min(headrooms))

    def admit_hbm(self, model: str, projected_bytes: int,
                  tenant: str = "", tier: int = 0) -> None:
        """Refuse a slot admission whose projected bytes exceed the safety
        fraction of the live headroom, with the typed 429
        (``shed_reason="memory"``)."""
        projected_bytes = max(0, int(projected_bytes))
        if not projected_bytes:
            return
        headroom = self.hbm_headroom()
        if headroom is None:
            return
        allowed = int(headroom * self.hbm_headroom_fraction)
        if projected_bytes <= allowed:
            return
        with self._lock:
            key = (model, self._track_tenant_locked(tenant), int(tier),
                   "hbm")
            self.shed[key] = self.shed.get(key, 0) + 1
        err = InferError(
            f"model '{model}': projected KV cache of {projected_bytes} "
            f"bytes exceeds the device memory headroom ({allowed} bytes "
            "usable); retry with a shorter prompt/generation or when "
            "running work completes", http_status=429,
            retry_after_s=1.0)
        err.shed_reason = "memory"
        raise err

    # -- pinned-KV lifetime accounting -------------------------------------
    def kv_pin(self, model: str, nbytes: int, tenant: str = "",
               now: Optional[float] = None) -> int:
        """Start the clock on a slot's pinned KV bytes; a handle for
        :meth:`kv_unpin`."""
        return self._pin(self._kv_pins, self._kv_pinned_by_model, model,
                         nbytes, tenant, now)

    def kv_unpin(self, handle: int,
                 now: Optional[float] = None) -> Tuple[str, float]:
        """Stop a slot's clock: ``(tenant, byte_seconds)`` of the interval,
        ``("", 0.0)`` for an unknown or released handle."""
        return self._unpin(self._kv_pins, self._kv_pinned_by_model, handle,
                           now)

    def cache_pin(self, model: str, nbytes: int, tenant: str = "",
                  now: Optional[float] = None) -> int:
        """Open the residency clock of one prefix-cache block
        (``nv_mem_cache_pinned_bytes``), charged to ``tenant``."""
        return self._pin(self._cache_pins, self._cache_pinned_by_model,
                         model, nbytes, tenant, now)

    def cache_unpin(self, handle: int,
                    now: Optional[float] = None) -> Tuple[str, float]:
        """Close a block's residency clock at eviction: ``(pinning tenant,
        byte_seconds)``, ``("", 0.0)`` for an unknown handle."""
        return self._unpin(self._cache_pins, self._cache_pinned_by_model,
                           handle, now)

    def _pin(self, pins, by_model, model, nbytes, tenant, now) -> int:
        nbytes = max(0, int(nbytes))
        now = time.monotonic() if now is None else now
        with self._lock:
            tenant = self._track_tenant_locked(tenant)
            handle = self._kv_next_handle
            self._kv_next_handle += 1
            pins[handle] = (model, tenant, nbytes, now)
            if nbytes:
                by_model[model] = by_model.get(model, 0) + nbytes
        return handle

    def _unpin(self, pins, by_model, handle, now) -> Tuple[str, float]:
        now = time.monotonic() if now is None else now
        with self._lock:
            entry = pins.pop(handle, None)
            if entry is None:
                return "", 0.0
            model, tenant, nbytes, t0 = entry
            if nbytes:
                left = by_model.get(model, 0) - nbytes
                if left > 0:
                    by_model[model] = left
                else:
                    by_model.pop(model, None)
            byte_seconds = nbytes * max(0.0, now - t0)
            key = (model, tenant)
            self.kv_byte_seconds[key] = \
                self.kv_byte_seconds.get(key, 0.0) + byte_seconds
        return tenant, byte_seconds

    def forget_model(self, model: str) -> None:
        """An unloaded model's open KV and cache pins close (its retired
        instance can no longer unpin them); their byte-seconds are
        booked."""
        with self._lock:
            handles = [(self._kv_pins, self._kv_pinned_by_model, h)
                       for h, e in self._kv_pins.items() if e[0] == model]
            handles += [(self._cache_pins, self._cache_pinned_by_model, h)
                        for h, e in self._cache_pins.items()
                        if e[0] == model]
        for pins, by_model, h in handles:
            self._unpin(pins, by_model, h, None)

    # -- export ------------------------------------------------------------
    def shed_total(self) -> int:
        with self._lock:
            return sum(self.shed.values())

    def metric_rows(self) -> Dict[str, List[Tuple[Dict[str, str], Any]]]:
        """The ``nv_mem_*`` sample rows by short family name, for
        ``/metrics`` and the JSON snapshot."""
        with self._lock:
            by_model = sorted(self.inflight_by_model.items())
            shed = sorted(self.shed.items())
            budget = (self._effective_budget_locked(time.monotonic())
                      if self.budget_bytes > 0 else None)
            kv_pinned = sorted(self._kv_pinned_by_model.items())
            cache_pinned = sorted(self._cache_pinned_by_model.items())
        rows: Dict[str, List[Tuple[Dict[str, str], Any]]] = {
            "inflight": [({"model": m}, v) for m, v in by_model],
            "budget": ([({}, budget)] if budget is not None else []),
            "shed": [({"model": m, "tenant": t, "tier": str(tier),
                       "reason": reason}, v)
                     for (m, t, tier, reason), v in shed],
            "kv_pinned": [({"model": m}, v) for m, v in kv_pinned],
            "cache_pinned": [({"model": m}, v) for m, v in cache_pinned],
            "hbm_headroom": [],
        }
        try:
            stats = self.hbm_stats_fn() or {}
        except Exception:  # noqa: BLE001 - observability must never raise
            stats = {}
        for dev, s in sorted(stats.items()):
            if "bytes_limit" in s:
                rows["hbm_headroom"].append(
                    ({"device": dev},
                     max(0, s["bytes_limit"] - s.get("bytes_in_use", 0))))
        return rows

    def snapshot(self) -> Dict[str, Any]:
        """The ``memory`` section of ``/v2/debug/device_stats``."""
        with self._lock:
            now = time.monotonic()
            budget = (self._effective_budget_locked(now)
                      if self.budget_bytes > 0 else None)
            out = {
                "budget_bytes": self.budget_bytes or None,
                "effective_budget_bytes": budget,
                # against the clock: a track-only governor never runs the
                # lazy reset, and an ended window must not read as active
                "pressure_active": (self._pressure_factor < 1.0
                                    and now < self._pressure_until),
                "pressure_events": self.pressure_events,
                "inflight_bytes": self.inflight_bytes,
                "peak_inflight_bytes": self.peak_inflight_bytes,
                "inflight_by_model": dict(self.inflight_by_model),
                "inflight_by_tenant": dict(self.inflight_by_tenant),
                "shed_total": sum(self.shed.values()),
                "shed": [
                    {"model": m, "tenant": t, "tier": tier,
                     "reason": reason, "count": v}
                    for (m, t, tier, reason), v in sorted(self.shed.items())
                ],
                "kv": {
                    "pinned_bytes_by_model": dict(self._kv_pinned_by_model),
                    "cache_pinned_bytes_by_model":
                        dict(self._cache_pinned_by_model),
                    "cache_pins": len(self._cache_pins),
                    "active_pins": len(self._kv_pins),
                    "byte_seconds_total": [
                        {"model": m, "tenant": t,
                         "byte_seconds": round(v, 6)}
                        for (m, t), v in sorted(
                            self.kv_byte_seconds.items())
                    ],
                },
            }
        out["hbm_headroom_bytes"] = self.hbm_headroom()
        return out
