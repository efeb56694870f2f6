"""Deterministic fault injection for the serving harness.

The port's copy of ``triton_client_tpu/server/chaos.py``: faults drawn per
request at a configured rate from a seeded ``random.Random``, so one seed
gives the same fault sequence in both packages (same arrivals in, same
faults out).  The data-plane kinds:

* ``latency`` -- a fixed delay before execution;
* ``error`` -- the request fails with a retryable status (503) before any
  compute;
* ``abort`` -- the HTTP frontend closes the connection mid-response, the
  gRPC-Web bridge ends the call UNAVAILABLE: the connection-class failure
  the client retry layer must absorb;
* ``mem_pressure`` -- the live host byte budget shrinks to
  ``pressure_factor`` of its bound for ``pressure_s`` seconds; the drawing
  request goes on;
* ``worker_kill`` -- the worker goes down: the core calls
  ``worker_kill_cb`` (a CLI ``--frontends`` worker exits with code 70; a
  drill's replica supervisor kills its replica and heals it), then fails
  the request as a severed connection.

One control-plane kind, never drawn by ``decide``:

* ``load_fail`` -- consumed by the core's ``load_model``
  (:meth:`ChaosInjector.maybe_fail_load`): a repository load fails before
  it touches the registry, as a corrupt artifact or an initializer out of
  memory would, under the same rate, seed and ``max_faults``.

One dispatch-plane kind, never drawn by ``decide``:

* ``device_error`` -- consumed by the decode worker at its dispatch
  boundaries (:meth:`ChaosInjector.maybe_device_fault`): the worker
  wrecks the bucket's cache and control tensors in place, then raises
  :class:`ChaosDeviceError`, so the drill runs the real rebuild, recovery
  and quarantine path.  With ``transient_s`` the fault is a blip a
  recovery rides out; without it a persistent fault drives the model into
  quarantine.

Every injected fault stamps the request's flight record (``chaos=<kind>``)
and the recorder pins it as an outlier.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, Iterable, Optional, Sequence

from .types import InferError

#: the kinds the port injects (the reference's, in its order)
_KINDS = ("latency", "error", "abort", "worker_kill", "load_fail",
          "mem_pressure", "device_error")
#: the kinds drawn per request by ``decide``; ``load_fail`` is
#: control-plane only (``maybe_fail_load``) and ``device_error``
#: dispatch-plane only (``maybe_device_fault``)
_DATA_KINDS = ("latency", "error", "abort", "worker_kill", "mem_pressure")


class ChaosAbort(InferError):
    """Injected connection abort: the HTTP frontend closes the connection
    in the middle of its answer, the gRPC-Web bridge ends the call
    UNAVAILABLE.  A 503 ``InferError``, so a path that does not
    special-case it still fails loudly."""

    def __init__(self, msg: str = "chaos: injected connection abort"):
        super().__init__(msg, http_status=503)


class ChaosDeviceError(RuntimeError):
    """Injected dispatch failure, shaped as PyTorch raises a failed CUDA
    launch.  Not an ``InferError``: a real failure surfaces from the
    dispatch call as a runtime error, and the decode worker's containment
    path (the wrecked bucket, its rebuild, recovery, quarantine) must see
    the same exception shape.  The reference mimics an XLA failure."""

    def __init__(self, model_name: str):
        super().__init__(
            "CUDA error: an illegal memory access was encountered "
            f"(injected device_error, chaos, model '{model_name}')")


class ChaosFault:
    """One injection decision.  ``latency_s`` is also the pressure window
    of a ``mem_pressure`` fault, ``pressure_factor`` its shrink."""

    __slots__ = ("kind", "latency_s", "status", "pressure_factor")

    def __init__(self, kind: str, latency_s: float = 0.0,
                 status: int = 503, pressure_factor: float = 0.5):
        self.kind = kind
        self.latency_s = latency_s
        self.status = status
        self.pressure_factor = pressure_factor


class ChaosInjector:
    """Seeded per-request fault source.

    ``decide(model)`` is called once per inference request, in arrival
    order; whether it fires is a draw from the seeded RNG.  ``models``
    limits injection to the named models (None: all); ``max_faults`` caps
    the injections.  ``transient_s``: after an injection the injector stays
    healthy that long, so a prompt retry lands clean (the draws then depend
    on timing)."""

    def __init__(
        self,
        rate: float,
        kinds: Sequence[str] = ("error",),
        seed: int = 0,
        latency_ms: float = 50.0,
        error_status: int = 503,
        models: Optional[Iterable[str]] = None,
        max_faults: Optional[int] = None,
        transient_s: float = 0.0,
        pressure_s: float = 1.0,
        pressure_factor: float = 0.5,
    ):
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"chaos rate must be in [0, 1], got {rate}")
        kinds = tuple(kinds)
        bad = [k for k in kinds if k not in _KINDS]
        if bad or not kinds:
            raise ValueError(
                f"chaos kinds must be drawn from {_KINDS}, got {kinds}")
        if not 0.0 < pressure_factor <= 1.0:
            raise ValueError(
                f"chaos pressure factor must be in (0, 1], got "
                f"{pressure_factor}")
        self.rate = float(rate)
        self.kinds = kinds
        self.seed = int(seed)
        self.latency_s = float(latency_ms) / 1e3
        self.error_status = int(error_status)
        self.models = set(models) if models else None
        self.max_faults = max_faults
        self.transient_s = float(transient_s)
        self.pressure_s = max(0.0, float(pressure_s))
        self.pressure_factor = float(pressure_factor)
        # the per-request pool: device_error never fires mid-infer
        self.data_kinds = tuple(k for k in kinds if k in _DATA_KINDS)
        #: what a worker_kill draw calls to take the worker down; unset,
        #: the drawing request still fails as a severed connection
        self.worker_kill_cb = None
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._healthy_until = 0.0
        self.injected_total = 0
        self.injected_by_model: Dict[str, int] = {}
        # (model, kind) -> count: what a drill compares its retries with
        self.injected_by_kind: Dict[tuple, int] = {}

    def _draw(self, model_name: str,
              pool: Sequence[str]) -> Optional[str]:
        """One rate-gated draw of a kind of ``pool`` under the lock (one
        RNG, one max_faults / transient budget), or None."""
        if self.rate <= 0.0 or not pool:
            return None
        if self.models is not None and model_name not in self.models:
            return None
        with self._lock:
            if (self.max_faults is not None
                    and self.injected_total >= self.max_faults):
                return None
            if self.transient_s > 0.0 \
                    and time.monotonic() < self._healthy_until:
                return None  # inside a transient's recovery window
            if self._rng.random() >= self.rate:
                return None
            kind = (pool[0] if len(pool) == 1
                    else pool[self._rng.randrange(len(pool))])
            if self.transient_s > 0.0:
                self._healthy_until = time.monotonic() + self.transient_s
            self.injected_total += 1
            self.injected_by_model[model_name] = \
                self.injected_by_model.get(model_name, 0) + 1
            key = (model_name, kind)
            self.injected_by_kind[key] = self.injected_by_kind.get(key, 0) + 1
        return kind

    def decide(self, model_name: str) -> Optional[ChaosFault]:
        """The verdict for one request (None: leave it alone)."""
        kind = self._draw(model_name, self.data_kinds)
        if kind is None:
            return None
        if kind == "latency":
            return ChaosFault("latency", latency_s=self.latency_s)
        if kind == "mem_pressure":
            return ChaosFault("mem_pressure", latency_s=self.pressure_s,
                              pressure_factor=self.pressure_factor)
        if kind in ("abort", "worker_kill"):
            return ChaosFault(kind)
        return ChaosFault("error", status=self.error_status)

    def maybe_fail_load(self, model_name: str) -> None:
        """The control-plane verdict for one repository load: raises the
        injected failure (503) when a ``load_fail`` draw fires, counted
        like every injection."""
        if "load_fail" not in self.kinds:
            return
        if self._draw(model_name, ("load_fail",)) is not None:
            raise InferError(
                f"chaos: injected load failure for '{model_name}'",
                http_status=503)

    def maybe_device_fault(self, model_name: str) -> bool:
        """The dispatch-plane verdict for one decode dispatch: True when a
        ``device_error`` draw fires (counted like every injection).  The
        caller wrecks its buffers and raises :class:`ChaosDeviceError`:
        only the decode worker knows which buffers a failed dispatch
        leaves behind."""
        if "device_error" not in self.kinds:
            return False
        return self._draw(model_name, ("device_error",)) is not None

    def counters(self) -> Dict[str, int]:
        """Injected faults per model (``nv_chaos_injected_total``)."""
        with self._lock:
            return dict(self.injected_by_model)

    def kind_counters(self) -> Dict[tuple, int]:
        """Injected faults per (model, kind)."""
        with self._lock:
            return dict(self.injected_by_kind)


def build_injector(rate: float, kinds_csv: str = "error", seed: int = 0,
                   latency_ms: float = 50.0,
                   models: Optional[Iterable[str]] = None,
                   transient_s: float = 0.0,
                   pressure_s: float = 1.0,
                   pressure_factor: float = 0.5) -> ChaosInjector:
    """The injector of the ``--chaos*`` flags; a ValueError on junk, so
    that a typo fails at start-up."""
    kinds = [k.strip() for k in kinds_csv.split(",") if k.strip()]
    return ChaosInjector(rate=rate, kinds=kinds, seed=seed,
                         latency_ms=latency_ms, models=models,
                         transient_s=transient_s, pressure_s=pressure_s,
                         pressure_factor=pressure_factor)
