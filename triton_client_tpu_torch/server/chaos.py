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
  request goes on.

The reference's other kinds belong to modules the port does not have yet
and are refused when an injector is built, naming their ROADMAP item:
``worker_kill`` (the fleet, A6b), ``load_fail`` (the repository API, A3b)
and ``device_error`` (device-fault containment, A7b).

Every injected fault stamps the request's flight record (``chaos=<kind>``)
and the recorder pins it as an outlier.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, Iterable, Optional, Sequence

from .types import InferError

#: the kinds the port injects; all are drawn per request by ``decide``
_KINDS = ("latency", "error", "abort", "mem_pressure")
#: the reference's kinds whose machinery is not ported -> ROADMAP item
NOT_PORTED_KINDS = {
    "worker_kill": "A6b (fleet)",
    "load_fail": "A3b (the repository API)",
    "device_error": "A7b (device-fault containment)",
}


class ChaosAbort(InferError):
    """Injected connection abort: the HTTP frontend closes the connection
    in the middle of its answer, the gRPC-Web bridge ends the call
    UNAVAILABLE.  A 503 ``InferError``, so a path that does not
    special-case it still fails loudly."""

    def __init__(self, msg: str = "chaos: injected connection abort"):
        super().__init__(msg, http_status=503)


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
        for k in kinds:
            if k in NOT_PORTED_KINDS:
                raise ValueError(
                    f"chaos kind '{k}' is not ported to "
                    "triton_client_tpu_torch yet (ROADMAP "
                    f"{NOT_PORTED_KINDS[k]})")
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
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._healthy_until = 0.0
        self.injected_total = 0
        self.injected_by_model: Dict[str, int] = {}
        # (model, kind) -> count: what a drill compares its retries with
        self.injected_by_kind: Dict[tuple, int] = {}

    def _draw(self, model_name: str) -> Optional[str]:
        """One rate-gated draw of a kind under the lock, or None."""
        pool = self.kinds
        if self.rate <= 0.0:
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
        kind = self._draw(model_name)
        if kind is None:
            return None
        if kind == "latency":
            return ChaosFault("latency", latency_s=self.latency_s)
        if kind == "mem_pressure":
            return ChaosFault("mem_pressure", latency_s=self.pressure_s,
                              pressure_factor=self.pressure_factor)
        if kind == "abort":
            return ChaosFault(kind)
        return ChaosFault("error", status=self.error_status)

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
    """The injector of the ``--chaos*`` flags; a ValueError on junk (or a
    kind not ported), so that a typo fails at start-up."""
    kinds = [k.strip() for k in kinds_csv.split(",") if k.strip()]
    return ChaosInjector(rate=rate, kinds=kinds, seed=seed,
                         latency_ms=latency_ms, models=models,
                         transient_s=transient_s, pressure_s=pressure_s,
                         pressure_factor=pressure_factor)
