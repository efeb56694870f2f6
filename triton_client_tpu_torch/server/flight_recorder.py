"""Always-on flight recorder: a bounded in-memory record of every request.

The port's copy of ``triton_client_tpu/server/flight_recorder.py``, with the
same records and JSON.  Sampled tracing (``trace.py``) shows a typical
request; this layer keeps every one:

* a **ring buffer** of the last N requests' summaries (request id,
  model and version, queue / compute / total durations, batch, bytes in
  and out, protocol, outcome), whatever the trace sampling;
* a per-model **streaming latency quantile** (``LatencyHistogram``);
* a **slow-request watchdog**: a request beyond the threshold (``p50`` /
  ``p90`` / ``p99`` of its model's live distribution, or an absolute
  number of milliseconds), or one that failed, is promoted after the fact
  to its full span tree and pinned in a last-N outliers buffer.

The core arms a **shadow trace context** (``RequestTracer.start_shadow``)
for every request the sampler skipped, so the span tree is there when the
watchdog wants it; nothing of it reaches the trace file.

Records are built per request; the shared buffers and counters change
under one short lock, with no IO, from any thread.

Surfaces: ``GET /v2/debug/flight_recorder``, the ``FlightRecorder`` RPC,
and ``nv_flight_recorder_captured_total`` /
``nv_inference_slow_request_total`` in ``/metrics``.  Each SLO pin and
each capture is also handed to the incident recorder (``incidents``),
whose detectors turn a run of them into a bundle.
"""

from __future__ import annotations

import itertools
import math
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from .._telemetry import LatencyHistogram
from .types import InferError

#: Quantile spellings accepted by ``capture_slower_than``.
_QUANTILES = {"p50": 0.50, "p90": 0.90, "p95": 0.95, "p99": 0.99,
              "p999": 0.999}


def parse_capture_threshold(spec: str):
    """``capture_slower_than`` spec -> ``(quantile, abs_ms)`` (one is None).

    Accepts ``"p50"``/``"p90"``/``"p95"``/``"p99"``/``"p999"`` (track the
    model's live latency distribution) or a positive number, interpreted as
    an absolute milliseconds bound (``"250"``, ``"1.5"``).  Raises
    ``InferError`` (400) on junk so a typo'd CLI flag fails loudly instead
    of silently disarming the watchdog.
    """
    spec = str(spec).strip().lower()
    if spec in _QUANTILES:
        return _QUANTILES[spec], None
    try:
        ms = float(spec)
    except ValueError:
        raise InferError(
            f"invalid capture_slower_than '{spec}': expected one of "
            f"{sorted(_QUANTILES)} or an absolute milliseconds value")
    if not math.isfinite(ms) or ms <= 0:
        # 'nan'/'inf' parse as floats but would silently disarm the
        # watchdog (total > nan is always False) — exactly the failure
        # mode this validator exists to prevent
        raise InferError(
            "capture_slower_than must be a positive finite value")
    return None, ms


def parse_snapshot_limit(value) -> int:
    """Validate a debug-surface ``limit`` parameter: a non-negative
    integer, as a CLIENT error (400 / INVALID_ARGUMENT) on junk.  Shared
    by the HTTP ``?limit=`` query parameter and the gRPC ``FlightRecorder``
    / ``DeviceStats`` RPCs so both wire surfaces reject identically —
    a malformed debug poll must never surface as a 500."""
    try:
        limit = int(value)
    except (TypeError, ValueError):
        raise InferError(
            f"invalid limit {value!r}: must be a non-negative integer")
    if limit < 0:
        raise InferError(
            f"invalid limit {limit}: must be a non-negative integer")
    return limit


class FlightRecord:
    """Compact summary of one request — what the ring buffer holds.

    Durations are filled at completion from the request's (shadow or
    sampled) span tree; ``spans`` is populated only when the watchdog pins
    the record into the outlier buffer.
    """

    __slots__ = ("seq", "request_id", "model", "version", "protocol",
                 "batch", "bytes_in", "bytes_out", "arrival_ns", "ts",
                 "queue_us", "compute_us", "total_us", "outcome",
                 "capture_reason", "spans", "tenant", "tier", "tick",
                 "cost", "chaos", "shed_reason", "fault", "recovered",
                 "cache_hit_tokens", "prefix_hash")

    def __init__(self, seq: int, model: str, version: str,
                 request_id: str = "", protocol: str = "",
                 batch: int = 1, bytes_in: int = 0,
                 tenant: str = "", tier: int = 0) -> None:
        self.seq = seq
        self.request_id = request_id
        self.model = model
        self.version = version
        self.protocol = protocol
        self.batch = batch
        self.bytes_in = bytes_in
        self.bytes_out = 0
        self.arrival_ns = time.monotonic_ns()
        self.ts = 0.0                       # wall clock, set at completion
        self.queue_us: Optional[float] = None
        self.compute_us: Optional[float] = None
        self.total_us = 0.0
        self.outcome = "ok"
        self.capture_reason: Optional[str] = None
        self.spans: Optional[List[dict]] = None
        # which tenant sent it, and its QoS tier
        self.tenant = tenant
        self.tier = tier
        # the batcher tick this request's execution rode, stamped by the
        # dynamic batcher so an outlier shows its tick shape
        self.tick: Optional[Dict[str, Any]] = None
        # this request's attributed device-time and FLOPs share and tenant
        # (costs.py): the join between the ring and the cost ledger
        self.cost: Optional[Dict[str, Any]] = None
        # the injected fault's kind (chaos.py): pinned as an outlier, so
        # injected weather is tellable from real weather
        self.chaos: Optional[str] = None
        # why an in-envelope shed refused it ("memory" for the governor's)
        self.shed_reason: Optional[str] = None
        # device-fault stamps (models/decode.py): the fault whose rebuild
        # interrupted this generation, and whether its recovery landed
        self.fault: Optional[str] = None
        self.recovered = False
        # the prefix cache's outcome (server/kvcache.py): prompt tokens
        # restored from stored blocks, and the deepest block's digest
        self.cache_hit_tokens = 0
        self.prefix_hash: Optional[str] = None

    def to_dict(self, include_spans: bool = False) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "seq": self.seq,
            "request_id": self.request_id,
            "model": self.model,
            "version": self.version,
            "protocol": self.protocol,
            "batch": self.batch,
            "bytes_in": self.bytes_in,
            "bytes_out": self.bytes_out,
            "ts": self.ts,
            "queue_us": self.queue_us,
            "compute_us": self.compute_us,
            "total_us": self.total_us,
            "outcome": self.outcome,
            "captured": self.capture_reason is not None,
            "capture_reason": self.capture_reason,
            "tenant": self.tenant,
            "tier": self.tier,
            "tick": self.tick,
            "cost": self.cost,
            "chaos": self.chaos,
            "shed_reason": self.shed_reason,
            "fault": self.fault,
            "recovered": self.recovered,
            "cache_hit_tokens": self.cache_hit_tokens,
            "prefix_hash": self.prefix_hash,
        }
        if include_spans:
            out["spans"] = self.spans or []
        return out


class FlightRecorder:
    """Lock-cheap fixed-size request recorder + slow-request watchdog."""

    DEFAULT_CAPACITY = 1024
    DEFAULT_OUTLIERS = 32
    #: Quantile thresholds stay disarmed below this many per-model samples —
    #: an early p99 over three requests would pin noise, not outliers.
    MIN_SAMPLES = 64
    #: Slack applied to quantile-mode thresholds.  The histogram reports a
    #: bucket's geometric midpoint (±~2.5% relative error), so on a
    #: hyper-stable distribution the raw p99 can land BELOW the common-case
    #: latency and flag every request; 5% slack (2x the error bound) makes
    #: "slower than p99" mean a real departure from the distribution.
    QUANTILE_SLACK = 1.05

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 outlier_capacity: int = DEFAULT_OUTLIERS,
                 capture_slower_than: str = "p99",
                 enabled: bool = True) -> None:
        self.enabled = enabled
        self._lock = threading.Lock()
        self._seq = itertools.count(1)
        self._quantile, self._abs_ms = parse_capture_threshold(
            capture_slower_than)
        self.capture_slower_than = str(capture_slower_than)
        self._ring: deque = deque(maxlen=max(1, int(capacity)))
        self._outliers: deque = deque(maxlen=max(1, int(outlier_capacity)))
        self._hists: Dict[str, LatencyHistogram] = {}
        self.recorded_total = 0
        self.slow_by_model: Dict[str, int] = {}
        self.captured_by_model: Dict[str, int] = {}
        # SLO burn-rate engine (server/device_stats.py), set by the core:
        # every completed request feeds its windows, and while a model is
        # breaching its multi-window burn threshold, SLO-bad requests are
        # pinned with full span trees — the p99 watchdog's retroactive
        # capture, triggered by budget math instead of a quantile
        self.slo_engine = None
        # the core's IncidentRecorder: SLO pins and captures escalate to
        # slo_burn and watchdog_storm bundles
        self.incidents = None

    def configure(self, capacity: Optional[int] = None,
                  outlier_capacity: Optional[int] = None,
                  capture_slower_than: Optional[str] = None,
                  enabled: Optional[bool] = None) -> None:
        """Apply the given settings only.  Resizing keeps the newest
        entries that still fit; histograms and the cumulative watchdog
        counters are never touched here — they back Prometheus ``counter``
        families, which must not go backwards on a runtime toggle.  Use
        ``reset()`` to drop recorded state wholesale."""
        with self._lock:
            if capture_slower_than is not None:
                self._quantile, self._abs_ms = parse_capture_threshold(
                    capture_slower_than)
                self.capture_slower_than = str(capture_slower_than)
            if capacity is not None:
                self._ring = deque(self._ring, maxlen=max(1, int(capacity)))
            if outlier_capacity is not None:
                self._outliers = deque(
                    self._outliers, maxlen=max(1, int(outlier_capacity)))
            if enabled is not None:
                self.enabled = bool(enabled)

    def reset(self) -> None:
        """Drop every buffer, histogram, and counter.  For tests and
        bench isolation — on a live server this makes the Prometheus
        counter families go backwards."""
        with self._lock:
            self._ring.clear()
            self._outliers.clear()
            self._hists = {}
            self.recorded_total = 0
            self.slow_by_model = {}
            self.captured_by_model = {}

    # -- per-request lifecycle ---------------------------------------------
    def start(self, model_name: str, version: str, request,
              batched: bool = True) -> FlightRecord:
        """Open a record at request entry (cheap: no locks, no IO).

        ``bytes_in`` sums wire tensor bytes / shm region sizes;
        ``batch`` is the leading dimension of the first input — but only
        for models that actually batch (``batched``): a non-batching
        model's rank-1 input of 8 elements serves batch 1, not 8."""
        batch = 1
        bytes_in = 0
        for t in request.inputs:
            if t.data is not None:
                bytes_in += int(getattr(t.data, "nbytes", 0))
            elif t.shm is not None:
                bytes_in += int(t.shm.byte_size)
        if batched and request.inputs:
            shape = request.inputs[0].shape
            if shape:
                batch = int(shape[0])
        return FlightRecord(
            next(self._seq), model_name, version,
            request_id=request.client_request_id or request.id,
            protocol=request.protocol, batch=batch, bytes_in=bytes_in,
            tenant=getattr(request, "tenant", ""),
            tier=getattr(request, "tier", 0))

    def complete(self, record: FlightRecord, trace) -> None:
        """Close a record from its finished span tree: fill durations,
        append to the ring, update the model's streaming quantile, and let
        the watchdog decide promotion.  Called exactly once per recorded
        request (from ``TraceContext.emit``)."""
        record.ts = time.time()
        queue_ns = compute_ns = 0
        root = None
        for s in trace.spans:
            if s.parent is None:
                root = s
            elif s.name == "QUEUE" and s.end_ns is not None:
                queue_ns += s.end_ns - s.start_ns
            elif s.name == "COMPUTE" and s.end_ns is not None:
                compute_ns += s.end_ns - s.start_ns
        if root is not None and root.end_ns is not None:
            total_ns = root.end_ns - root.start_ns
        else:
            total_ns = time.monotonic_ns() - record.arrival_ns
        record.total_us = total_ns / 1e3
        if queue_ns:
            record.queue_us = queue_ns / 1e3
        if compute_ns:
            record.compute_us = compute_ns / 1e3

        # threshold is evaluated against the distribution BEFORE this
        # sample joins it (a request must not raise the bar it is judged
        # against); only SUCCESSES feed the histogram — a burst of
        # fast-failing requests must not drag the p99 threshold down to
        # failure-validation latency (failures are always captured anyway).
        # With the recorder disabled (records flow only because the model
        # has an SLO objective) the watchdog is off: no histogram feed, no
        # slow-threshold — only the SLO windows below see the request.
        threshold_us = None
        if self.enabled:
            hist = self._hists.get(record.model)
            if hist is None:
                with self._lock:
                    hist = self._hists.setdefault(
                        record.model, LatencyHistogram())
            threshold_us = self._threshold_us(hist)
            if record.outcome == "ok":
                hist.observe(total_ns / 1e9)

        # SLO windows see EVERY completed request (good ones must dilute
        # the bad fraction); the verdict — SLO-bad while the model burns
        # over threshold on both windows — is one more capture trigger
        slo_pin = False
        if self.slo_engine is not None:
            slo_pin = self.slo_engine.observe(
                record.model, record.total_us, record.outcome == "ok")

        # a slow FAILURE (the canonical timeout) is both: counted slow
        # below, captured as "failed"
        is_slow = threshold_us is not None and record.total_us > threshold_us
        if not self.enabled:
            # recorder off: breach pinning is the SLO engine's feature and
            # survives; every other capture class belongs to the recorder
            record.capture_reason = "slo_breach" if slo_pin else None
        elif record.outcome != "ok":
            record.capture_reason = "failed"
        elif is_slow:
            record.capture_reason = "slow"
        elif slo_pin:
            record.capture_reason = "slo_breach"
        elif record.chaos is not None:
            # injected faults are always pinned, even when the request
            # survived them
            record.capture_reason = f"chaos:{record.chaos}"
        if record.capture_reason is not None:
            # the retroactive promotion: snapshot the full span tree the
            # shadow context carried all along (built before the lock —
            # only O(1) appends/bumps happen inside it)
            record.spans = [
                {"name": s.name, "start_ns": s.start_ns,
                 "end_ns": s.end_ns if s.end_ns is not None else s.start_ns,
                 "parent": s.parent}
                for s in trace.spans
            ]
        # buffer appends share the counter lock: complete() runs on
        # executor threads while snapshot()/metrics iterate on the event
        # loop, and an unlocked deque append mid-iteration raises
        with self._lock:
            if self.enabled:
                self._ring.append(record)
                self.recorded_total += 1
                if is_slow:
                    self.slow_by_model[record.model] = \
                        self.slow_by_model.get(record.model, 0) + 1
            if record.capture_reason is not None:
                self.captured_by_model[record.model] = \
                    self.captured_by_model.get(record.model, 0) + 1
                self._outliers.append(record)
        # the incident recorder's detectors, outside the lock: they take
        # the recorder's own lock and may start a bundle's writer
        if self.incidents is not None:
            if slo_pin:
                self.incidents.note_breach(record.model)
            if record.capture_reason is not None:
                self.incidents.note_capture()

    def _threshold_us(self, hist: LatencyHistogram) -> Optional[float]:
        if self._abs_ms is not None:
            return self._abs_ms * 1e3
        if hist.count < self.MIN_SAMPLES:
            return None
        q = hist.quantile(self._quantile)
        return q * 1e6 * self.QUANTILE_SLACK if q == q else None  # NaN-safe

    def threshold_us(self, model: str) -> Optional[float]:
        """The live capture threshold for ``model`` (None = disarmed)."""
        hist = self._hists.get(model)
        if hist is None:
            return self._abs_ms * 1e3 if self._abs_ms is not None else None
        return self._threshold_us(hist)

    # -- debug surface ------------------------------------------------------
    def watchdog_counters(self):
        """(slow_by_model, captured_by_model) copied under the lock —
        for renderers that would otherwise iterate the live dicts while
        an executor-thread complete() inserts a model's first capture."""
        with self._lock:
            return dict(self.slow_by_model), dict(self.captured_by_model)

    def snapshot(self, model: Optional[str] = None,
                 limit: int = 0) -> Dict[str, Any]:
        """The ``/v2/debug/flight_recorder`` JSON: recent ring + pinned
        outliers (both oldest-to-newest) + per-model live quantiles.
        ``model`` filters entries; ``limit`` caps the ring slice to the
        most recent N (0 = the whole ring)."""
        with self._lock:
            ring = list(self._ring)
            pinned = list(self._outliers)
            hists = dict(self._hists)
            slow = dict(self.slow_by_model)
            captured = dict(self.captured_by_model)
            recorded_total = self.recorded_total
        recent = [r for r in ring if model is None or r.model == model]
        if limit and limit > 0:
            recent = recent[-limit:]
        outliers = [r for r in pinned if model is None or r.model == model]
        models: Dict[str, Any] = {}
        for name, hist in sorted(hists.items()):
            if model is not None and name != model:
                continue
            thr = self._threshold_us(hist)

            def _ms(q, _h=hist):
                v = _h.quantile(q)
                return round(v * 1e3, 3) if v == v else None

            models[name] = {
                "count": hist.count,
                "mean_ms": (round(hist.mean() * 1e3, 3)
                            if hist.count else None),
                "p50_ms": _ms(0.50),
                "p90_ms": _ms(0.90),
                "p99_ms": _ms(0.99),
                "threshold_ms": (round(thr / 1e3, 3)
                                 if thr is not None else None),
                "slow_total": slow.get(name, 0),
                "captured_total": captured.get(name, 0),
            }
        return {
            "enabled": self.enabled,
            "capture_slower_than": self.capture_slower_than,
            "ring_capacity": self._ring.maxlen,
            "outlier_capacity": self._outliers.maxlen,
            "recorded_total": recorded_total,
            "models": models,
            "recent": [r.to_dict() for r in recent],
            "outliers": [self._with_age(r) for r in outliers],
        }

    @staticmethod
    def _with_age(record: FlightRecord) -> Dict[str, Any]:
        out = record.to_dict(include_spans=True)
        # age computed on the SERVER's clock: a remote consumer (on
        # another host) must not difference its own time.time() against
        # ours — clock skew would turn an 8s-old outlier into
        # "38s ago" or clamp it to zero
        out["age_s"] = round(max(0.0, time.time() - record.ts), 1)
        return out
