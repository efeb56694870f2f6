"""Device- and scheduler-level observability: device statistics, the
batcher tick profiler, and an SLO burn-rate engine.

The port's counterpart of ``triton_client_tpu/server/device_stats.py``,
with the same classes, metric rows and JSON:

* :class:`DeviceStatsCollector`: per model, **live MFU** (FLOPs of the
  executed batches over their compute time over the card's peak) and
  **duty cycle** (the share of a sliding window inside COMPUTE windows);
  **HBM** in use, peak and limit; **host<->device transfers**; and
  **signature events**: the first execution of a new input signature is
  the reference's compile event (a jit-cache miss), here the execution the
  core counts FLOPs and bytes in (``costs.py``).  It is kept out of the
  duty and MFU window, as the reference keeps its compile out.  The
  ``nv_tpu_*`` family names are the reference's, kept for its dashboards.
* the **batcher tick profiler** (on the collector): one record per
  dynamic-batcher execution -- bucket, real and padded rows (pad waste),
  queue depth at assembly, assembly time -- aggregated per (model,
  bucket).
* :class:`SloEngine`: per-model SLO objectives (p99 target and
  availability) under Google SRE's multi-window burn rate over 5 m and 1 h
  windows; while a model breaches, each SLO-bad request is pinned in the
  flight recorder.

On the card a COMPUTE window is timed with CUDA events around the
execution (the core's), not on the host clock: ``execute`` returns once
the kernels are queued, so a host window would read the launch time.

Every ``record_*`` takes one short lock and does no IO.  Every clock
takes an injectable ``now`` so the burn-rate tests run on synthetic time.
"""

from __future__ import annotations

import os
import threading
import time
import warnings
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from .costs import SignatureCost, classify_roofline

__all__ = [
    "DeviceStatsCollector",
    "SloEngine",
    "SloObjective",
    "parse_slo_spec",
    "peak_flops",
]

#: burn-rate windows (label -> seconds); both must burn for a breach
SLO_WINDOWS: Dict[str, float] = {"5m": 300.0, "1h": 3600.0}

#: default multi-window breach threshold (the canonical fast-burn page)
DEFAULT_BURN_THRESHOLD = 14.4


#: H100 SXM dense bf16 peak, NVIDIA's data-sheet figure for the card (not a
#: measurement): the port's one MFU denominator.  As in the reference, one
#: peak serves every model, int8 ones too (the card's int8 peak is twice
#: it), and ``chip_smoke.py`` bounds its kernels with this same constant.
#: ``TRITON_TPU_PEAK_FLOPS`` overrides it.
DEFAULT_PEAK_FLOPS = 989e12


def peak_flops() -> float:
    """Peak FLOP/s for MFU denominators: ``TRITON_TPU_PEAK_FLOPS``, else
    :data:`DEFAULT_PEAK_FLOPS`."""
    env = os.environ.get("TRITON_TPU_PEAK_FLOPS")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    return DEFAULT_PEAK_FLOPS


class _ModelCompute:
    """Per-model compute accounting: a sliding window of COMPUTE events
    (for duty cycle / live MFU) plus cumulative counters."""

    __slots__ = ("events", "compute_ns_total", "executions", "flops_total",
                 "inferences")

    def __init__(self) -> None:
        # (end_monotonic_s, compute_s, flops) — pruned past the window
        self.events: deque = deque()
        self.compute_ns_total = 0
        self.executions = 0
        self.inferences = 0
        self.flops_total = 0.0


class _ModelCompile:
    """Per-model signature events: the first execution of a new input
    signature (the reference's compile; the port's counted execution)."""

    __slots__ = ("signatures", "compile_count", "compile_ns_total",
                 "hits", "recent")
    RECENT = 16

    def __init__(self) -> None:
        self.signatures: set = set()
        self.compile_count = 0
        self.compile_ns_total = 0
        self.hits = 0
        # last-N compile events for the debug snapshot: (sig repr, wall_ms)
        self.recent: deque = deque(maxlen=self.RECENT)


class _BucketStats:
    """Aggregated tick records for one (model, bucket) pair."""

    __slots__ = ("ticks", "batch_total", "padded_total", "requests_total",
                 "assembly_ns_total", "queue_depth_total", "queue_depth_max",
                 "syncs_total", "compute_ns_total", "steps_total",
                 "uploads_total", "flops_total", "bytes_total",
                 "first_seq", "last_seq")

    def __init__(self) -> None:
        self.ticks = 0
        self.batch_total = 0
        self.padded_total = 0
        self.requests_total = 0
        self.assembly_ns_total = 0
        self.queue_depth_total = 0
        self.queue_depth_max = 0
        self.syncs_total = 0
        self.compute_ns_total = 0
        self.steps_total = 0
        self.uploads_total = 0
        # counted cost totals for the executions behind these ticks
        # (full padded-batch FLOPs / bytes accessed per dispatch) — the
        # roofline classification inputs; 0 = analysis unavailable
        self.flops_total = 0.0
        self.bytes_total = 0.0
        # host-side dispatch sequence window (tick_seq): the join key a
        # traced sequence's tick entries carry — a trace's tick_seq must
        # land inside [first_seq, last_seq] of its (model, bucket) row
        self.first_seq = 0
        self.last_seq = 0

    def pad_waste(self) -> float:
        """Cumulative padded-but-unused fraction of executed batch slots."""
        if not self.padded_total:
            return 0.0
        return 1.0 - self.batch_total / self.padded_total


class DeviceStatsCollector:
    """Always-on device/scheduler stats: compute windows, compiles,
    transfers, and batcher ticks.  ``enabled=False`` turns every
    ``record_*`` into a no-op (the bench A/B lever)."""

    #: Sliding window for duty cycle / live MFU gauges.
    WINDOW_S = 60.0

    def __init__(self, window_s: float = WINDOW_S) -> None:
        self.enabled = True
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        self._started_s = time.monotonic()
        self._compute: Dict[str, _ModelCompute] = {}
        self._compile: Dict[str, _ModelCompile] = {}
        # (model, bucket) -> _BucketStats; bucket = padded batch size
        self._buckets: Dict[Tuple[str, int], _BucketStats] = {}
        # direction ("h2d" | "d2h") -> [count, bytes]
        self._transfers: Dict[str, List[int]] = {}
        # model -> flops per batch element (None = undeclared, no MFU)
        self._flops_pe: Dict[str, Optional[float]] = {}
        # (model, signature) -> counted SignatureCost, cached at the
        # signature's first compile (the core runs the AOT analysis and
        # hands it to record_execute alongside the compile sample)
        self._sig_costs: Dict[Tuple[str, tuple], SignatureCost] = {}
        # model -> measured flops per batch element (cost_analysis FLOPs
        # over the padded batch of the analyzed signature) — when
        # present this beats the hand-declared figure as MFU numerator
        self._flops_measured: Dict[str, float] = {}
        # models already warned about declared-vs-measured flops drift
        self._drift_warned: set = set()
        # device -> allocator peak kept across cost-analysis resets
        self._peak_floor: Dict[str, int] = {}

    # -- recording ---------------------------------------------------------
    def declare_model(self, model: str,
                      flops_per_element: Optional[float]) -> None:
        """Hot-path variant of :meth:`set_model_flops`: the lock-free dict
        probe makes repeat calls per-execute cheap; only the first call
        per model pays the lock."""
        if model in self._flops_pe:
            return
        with self._lock:
            self._flops_pe.setdefault(model, flops_per_element)

    def forget_model(self, model: str) -> None:
        """A reloaded or unloaded model's FLOPs declaration, measured
        FLOPs and signatures with their counted costs go (its next
        instance counts anew); cumulative counters stay."""
        with self._lock:
            self._flops_pe.pop(model, None)
            self._flops_measured.pop(model, None)
            self._drift_warned.discard(model)
            self._sig_costs = {k: v for k, v in self._sig_costs.items()
                               if k[0] != model}
            cc = self._compile.get(model)
            if cc is not None:
                cc.signatures = set()

    def signature_known(self, model: str, signature: tuple) -> bool:
        """Whether this input-shape signature has been seen (i.e. its
        compile — and cost analysis, if available — already happened).
        The core probes this before paying an AOT cost analysis."""
        with self._lock:
            cc = self._compile.get(model)
            return cc is not None and signature in cc.signatures

    def signature_cost(self, model: str,
                       signature: tuple) -> Optional[SignatureCost]:
        """The cached counted cost for a (model, signature), or None when
        analysis was unavailable for it."""
        with self._lock:
            return self._sig_costs.get((model, signature))

    def record_execute(self, model: str, batch: int, compute_ns: int,
                       signature: Optional[tuple] = None,
                       now: Optional[float] = None,
                       cost: Optional[SignatureCost] = None,
                       padded_batch: Optional[int] = None) -> None:
        """Record one model execution window.

        ``signature`` (input-shape signature) drives the compile series:
        its first sighting is the reference's jit-cache miss and the port's
        counted execution (which runs under the dispatch modes of
        ``costs.py``), so that sample feeds the compile counters and is
        kept out of the duty/MFU window.

        ``cost`` (the count of a signature's first execution) is cached
        per (model, signature) and its FLOPs, over ``padded_batch`` (the
        executed batch), become the model's *measured* flops-per-element,
        the live-MFU numerator preferred over the declared figure."""
        if not self.enabled:
            return
        now = time.monotonic() if now is None else now
        drift: Optional[Tuple[float, float]] = None
        with self._lock:
            cm = self._compute.get(model)
            if cm is None:
                cm = self._compute.setdefault(model, _ModelCompute())
            compiled = False
            if signature is not None:
                cc = self._compile.get(model)
                if cc is None:
                    cc = self._compile.setdefault(model, _ModelCompile())
                if signature not in cc.signatures:
                    cc.signatures.add(signature)
                    cc.compile_count += 1
                    cc.compile_ns_total += compute_ns
                    event = {"signature": repr(signature),
                             "wall_ms": round(compute_ns / 1e6, 3)}
                    if cost is not None:
                        self._sig_costs[(model, signature)] = cost
                        event["flops"] = cost.flops
                        event["bytes_accessed"] = cost.bytes_accessed
                        if cost.flops > 0.0:
                            measured_pe = cost.flops / max(
                                1, int(padded_batch or batch or 1))
                            self._flops_measured[model] = measured_pe
                            declared = self._flops_pe.get(model)
                            if declared and model not in self._drift_warned:
                                ratio = declared / measured_pe
                                if ratio > 2.0 or ratio < 0.5:
                                    self._drift_warned.add(model)
                                    drift = (declared, measured_pe)
                    cc.recent.append(event)
                    compiled = True
                else:
                    cc.hits += 1
            cm.executions += 1
            cm.inferences += max(1, int(batch))
            if not compiled:
                cm.compute_ns_total += compute_ns
                flops_pe = (self._flops_measured.get(model)
                            or self._flops_pe.get(model))
                flops = (flops_pe * max(1, int(batch))
                         if flops_pe else 0.0)
                cm.flops_total += flops
                cm.events.append((now, compute_ns / 1e9, flops))
                self._prune_locked(cm, now)
        if drift is not None:
            declared, measured_pe = drift
            warnings.warn(
                f"model '{model}': declared flops_per_inference "
                f"({declared:.3e}) drifts >2x from the counted flops per "
                f"element ({measured_pe:.3e}); live MFU uses the measured "
                "figure", RuntimeWarning, stacklevel=2)

    def record_transfer(self, direction: str, nbytes: int,
                        count: int = 1) -> None:
        """Count host<->device transfers (``h2d`` | ``d2h``): shm
        staging DMAs and executor D2H readback drains."""
        if not self.enabled:
            return
        with self._lock:
            c = self._transfers.setdefault(direction, [0, 0])
            c[0] += int(count)
            c[1] += int(nbytes)

    def record_tick(self, model: str, bucket: int, batch: int, padded: int,
                    queue_depth: int, assembly_ns: int, compute_ns: int = 0,
                    requests: int = 1, syncs: int = 0, steps: int = 1,
                    uploads: int = 0, tick_seq: int = 0, flops: float = 0.0,
                    bytes_accessed: float = 0.0) -> None:
        """Record one dynamic-batcher tick (one batched execution) or one
        decode-worker fused dispatch.

        ``steps``: device steps fused into the dispatch (a batcher tick
        is one step; the decode fast path runs up to T — dividing
        ``steps_total`` by ``ticks`` gives steps-per-dispatch, the
        multi-step amortization the fused tick exists for).
        ``uploads``: host->device CONTROL-state uploads the dispatch
        paid (0 on the steady-state generation path — the regression
        counter that proves per-tick control re-uploads stay gone).
        ``tick_seq``: the decode worker's monotonic dispatch id (0 = not
        stamped, e.g. batcher ticks) — the same id each traced sequence's
        tick entries carry, so trace records join back to these rows.
        ``flops`` / ``bytes_accessed``: the dispatch's counted cost
        figures (full padded batch; 0 = unavailable) — accumulated per
        (model, bucket) as the roofline classification inputs."""
        if not self.enabled:
            return
        with self._lock:
            bs = self._buckets.get((model, bucket))
            if bs is None:
                bs = self._buckets.setdefault((model, bucket),
                                              _BucketStats())
            bs.ticks += 1
            bs.batch_total += int(batch)
            bs.padded_total += int(padded)
            bs.requests_total += int(requests)
            bs.assembly_ns_total += int(assembly_ns)
            bs.queue_depth_total += int(queue_depth)
            bs.queue_depth_max = max(bs.queue_depth_max, int(queue_depth))
            bs.syncs_total += int(syncs)
            bs.compute_ns_total += int(compute_ns)
            bs.steps_total += int(steps)
            bs.uploads_total += int(uploads)
            bs.flops_total += float(flops)
            bs.bytes_total += float(bytes_accessed)
            if tick_seq:
                if not bs.first_seq:
                    bs.first_seq = int(tick_seq)
                bs.last_seq = max(bs.last_seq, int(tick_seq))

    def _prune_locked(self, cm: _ModelCompute, now: float) -> None:
        horizon = now - self.window_s
        while cm.events and cm.events[0][0] < horizon:
            cm.events.popleft()

    # -- derived gauges ----------------------------------------------------
    def duty_cycle(self, model: str, now: Optional[float] = None
                   ) -> Optional[float]:
        """Fraction of the sliding window spent inside this model's COMPUTE
        windows, clamped to [0, 1] (pipelined batches overlap — saturation
        reads as 1.0).  None before any execution."""
        now = time.monotonic() if now is None else now
        with self._lock:
            cm = self._compute.get(model)
            if cm is None:
                return None
            self._prune_locked(cm, now)
            span = min(self.window_s, max(1e-9, now - self._started_s))
            busy = sum(e[1] for e in cm.events)
        return min(1.0, busy / span)

    def live_mfu(self, model: str, now: Optional[float] = None
                 ) -> Optional[float]:
        """Windowed MFU: FLOPs executed over elapsed compute time over
        chip peak.  The numerator prefers counted flops-per-element
        (cost analysis at first compile) over the hand-declared figure.
        None for models with neither (or no window traffic) — an unknown
        model must read as "unknown", not 0% utilization."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if not (self._flops_measured.get(model)
                    or self._flops_pe.get(model)):
                return None
            cm = self._compute.get(model)
            if cm is None:
                return None
            self._prune_locked(cm, now)
            busy = sum(e[1] for e in cm.events)
            flops = sum(e[2] for e in cm.events)
        if busy <= 0:
            return None
        return flops / busy / peak_flops()

    def pad_waste(self, model: Optional[str] = None) -> Optional[float]:
        """Cumulative pad-waste fraction across ticks (one model, or every
        bucketed model when ``model`` is None).  None with no ticks."""
        with self._lock:
            items = [bs for (m, _), bs in self._buckets.items()
                     if model is None or m == model]
            batch = sum(bs.batch_total for bs in items)
            padded = sum(bs.padded_total for bs in items)
        if not padded:
            return None
        return 1.0 - batch / padded

    def note_peak(self, device: str, peak_bytes: int) -> None:
        """Keep a device's allocator peak before a cost analysis resets it
        (``costs.analyze_torch_callable``), so ``peak_bytes_in_use`` stays
        the peak since the process started."""
        with self._lock:
            self._peak_floor[device] = max(self._peak_floor.get(device, 0),
                                           int(peak_bytes))

    def hbm_stats(self) -> Dict[str, Dict[str, int]]:
        """Per-device memory from the CUDA caching allocator:
        ``bytes_in_use`` is the bytes allocated to tensors
        (``allocated_bytes.all.current``), not what the allocator has
        reserved from the driver, as XLA's ``bytes_in_use`` counts live
        buffers; ``peak_bytes_in_use`` their peak since start;
        ``bytes_limit`` the card's total memory (``mem_get_info``).  Empty
        where there is no card: the family is absent, never made up."""
        out: Dict[str, Dict[str, int]] = {}
        try:
            import torch

            if not torch.cuda.is_available() or \
                    not torch.cuda.is_initialized():
                return out
            for i in range(torch.cuda.device_count()):
                stats = torch.cuda.memory_stats(i)
                label = f"cuda:{i}"
                with self._lock:
                    floor = self._peak_floor.get(label, 0)
                out[label] = {
                    "bytes_in_use": int(stats.get(
                        "allocated_bytes.all.current", 0)),
                    "peak_bytes_in_use": max(floor, int(stats.get(
                        "allocated_bytes.all.peak", 0))),
                    "bytes_limit": int(torch.cuda.mem_get_info(i)[1]),
                }
        except Exception:  # noqa: BLE001 - observability must never raise
            return {}
        return out

    # -- export ------------------------------------------------------------
    def metric_rows(self, now: Optional[float] = None) -> Dict[str, list]:
        """The ``nv_tpu_*`` sample rows, keyed by short family name — one
        source for both the Prometheus renderer and the JSON snapshot."""
        now = time.monotonic() if now is None else now
        with self._lock:
            models = sorted(self._compute)
            # duty + MFU in ONE pass over each model's event window, under
            # the one lock acquisition: /metrics scrapes run this against
            # windows holding tens of thousands of events at high QPS, and
            # per-model duty_cycle()/live_mfu() calls would re-lock and
            # re-sum the same deque three times over
            span = min(self.window_s, max(1e-9, now - self._started_s))
            duty_mfu: Dict[str, tuple] = {}
            for m, cm in self._compute.items():
                self._prune_locked(cm, now)
                busy = flops = 0.0
                for e in cm.events:
                    busy += e[1]
                    flops += e[2]
                mfu = (flops / busy / peak_flops()
                       if busy > 0 and (self._flops_measured.get(m)
                                        or self._flops_pe.get(m)) else None)
                duty_mfu[m] = (min(1.0, busy / span), mfu)
            compiles = {m: (c.compile_count, c.compile_ns_total, c.hits)
                        for m, c in self._compile.items()}
            buckets = sorted(self._buckets.items())
            transfers = {d: list(c) for d, c in self._transfers.items()}
        rows: Dict[str, list] = {
            "duty_cycle": [], "live_mfu": [],
            "compile_total": [], "compile_us": [],
            "jit_hit": [], "jit_miss": [],
            "transfer_total": [], "transfer_bytes": [],
            "tick_total": [], "tick_batch": [], "tick_padded": [],
            "tick_assembly_us": [], "tick_queue_depth": [],
            "tick_syncs": [], "tick_steps": [], "tick_uploads": [],
            "pad_waste": [],
            "roofline_ai": [], "roofline_pct": [],
            "mem_used": [], "mem_peak": [], "mem_limit": [],
        }
        for m in models:
            duty, mfu = duty_mfu[m]
            rows["duty_cycle"].append(({"model": m}, round(duty, 6)))
            if mfu is not None:
                rows["live_mfu"].append(({"model": m}, round(mfu, 6)))
        for m, (count, ns, hits) in sorted(compiles.items()):
            labels = {"model": m}
            rows["compile_total"].append((labels, count))
            rows["compile_us"].append((labels, ns // 1000))
            rows["jit_hit"].append((labels, hits))
            rows["jit_miss"].append((labels, count))
        for d, (count, nbytes) in sorted(transfers.items()):
            labels = {"direction": d}
            rows["transfer_total"].append((labels, count))
            rows["transfer_bytes"].append((labels, nbytes))
        for (m, bucket), bs in buckets:
            labels = {"model": m, "bucket": str(bucket)}
            rows["tick_total"].append((labels, bs.ticks))
            rows["tick_batch"].append((labels, bs.batch_total))
            rows["tick_padded"].append((labels, bs.padded_total))
            rows["tick_assembly_us"].append(
                (labels, bs.assembly_ns_total // 1000))
            rows["tick_queue_depth"].append((labels, bs.queue_depth_total))
            rows["tick_syncs"].append((labels, bs.syncs_total))
            rows["tick_steps"].append((labels, bs.steps_total))
            rows["tick_uploads"].append((labels, bs.uploads_total))
            rows["pad_waste"].append((labels, round(bs.pad_waste(), 6)))
            roofline = classify_roofline(
                bs.flops_total, bs.bytes_total,
                compute_s=bs.compute_ns_total / 1e9)
            if roofline is not None:
                rows["roofline_ai"].append(
                    (labels, roofline["arithmetic_intensity"]))
                if "pct_of_peak" in roofline:
                    rows["roofline_pct"].append(
                        ({"model": m, "bucket": str(bucket),
                          "verdict": roofline["verdict"]},
                         roofline["pct_of_peak"]))
        for dev, stats in sorted(self.hbm_stats().items()):
            labels = {"device": dev}
            if "bytes_in_use" in stats:
                rows["mem_used"].append((labels, stats["bytes_in_use"]))
            if "peak_bytes_in_use" in stats:
                rows["mem_peak"].append((labels, stats["peak_bytes_in_use"]))
            if "bytes_limit" in stats:
                rows["mem_limit"].append((labels, stats["bytes_limit"]))
        return rows

    def snapshot(self, model: Optional[str] = None,
                 now: Optional[float] = None) -> Dict[str, Any]:
        """The ``/v2/debug/device_stats`` JSON: per-model compute/compile
        summaries, per-(model, bucket) tick aggregates, transfer counters,
        and live HBM stats.  ``model`` filters the per-model sections."""
        now = time.monotonic() if now is None else now
        # copy every per-model field INSIDE the lock: _ModelCompute /
        # _ModelCompile objects are shared with record_execute on executor
        # threads, and iterating cc.recent unlocked races a concurrent
        # append (deque mutated during iteration -> a 500 on the debug
        # surface exactly when an operator is polling it)
        with self._lock:
            compute = {m: (cm.executions, cm.inferences, cm.compute_ns_total)
                       for m, cm in self._compute.items()}
            compiles = {m: (c.compile_count, c.compile_ns_total, c.hits,
                            list(c.recent))
                        for m, c in self._compile.items()}
            buckets = sorted(self._buckets.items())
            transfers = {d: list(c) for d, c in self._transfers.items()}
            flops_measured = dict(self._flops_measured)
            flops_declared = dict(self._flops_pe)
        models: Dict[str, Any] = {}
        for m, (executions, inferences, compute_ns) in sorted(
                compute.items()):
            if model is not None and m != model:
                continue
            count, compile_ns, hits, recent = compiles.get(
                m, (0, 0, 0, []))
            duty = self.duty_cycle(m, now)
            mfu = self.live_mfu(m, now)
            measured = flops_measured.get(m)
            declared = flops_declared.get(m)
            models[m] = {
                "executions": executions,
                "inferences": inferences,
                "compute_ms_total": round(compute_ns / 1e6, 3),
                "duty_cycle": round(duty, 6) if duty is not None else None,
                "live_mfu": round(mfu, 6) if mfu is not None else None,
                # MFU-numerator provenance: counted beats declared;
                # neither -> MFU is honestly absent, never fabricated
                "flops_per_element": measured or declared,
                "flops_source": ("measured" if measured
                                 else "declared" if declared else None),
                "flops_declared": declared,
                "compile": {
                    "count": count,
                    "total_ms": round(compile_ns / 1e6, 3),
                    "jit_cache_hits": hits,
                    "jit_cache_misses": count,
                    "recent": recent,
                },
            }
        ticks: Dict[str, Any] = {}
        for (m, bucket), bs in buckets:
            if model is not None and m != model:
                continue
            entry = ticks.setdefault(m, {})
            entry[str(bucket)] = {
                "ticks": bs.ticks,
                "requests": bs.requests_total,
                "batch_total": bs.batch_total,
                "padded_total": bs.padded_total,
                "avg_batch": (round(bs.batch_total / bs.ticks, 2)
                              if bs.ticks else None),
                "pad_waste": round(bs.pad_waste(), 4),
                "avg_assembly_us": (round(
                    bs.assembly_ns_total / bs.ticks / 1e3, 1)
                    if bs.ticks else None),
                "avg_queue_depth": (round(
                    bs.queue_depth_total / bs.ticks, 2)
                    if bs.ticks else None),
                "max_queue_depth": bs.queue_depth_max,
                "syncs": bs.syncs_total,
                "steps": bs.steps_total,
                "avg_steps_per_tick": (round(
                    bs.steps_total / bs.ticks, 2) if bs.ticks else None),
                "uploads": bs.uploads_total,
                "flops_total": bs.flops_total,
                "bytes_total": bs.bytes_total,
                "roofline": classify_roofline(
                    bs.flops_total, bs.bytes_total,
                    compute_s=bs.compute_ns_total / 1e9),
                "first_tick_seq": bs.first_seq or None,
                "last_tick_seq": bs.last_seq or None,
            }
        return {
            "enabled": self.enabled,
            "window_s": self.window_s,
            "models": models,
            "ticks": ticks,
            "transfers": {
                d: {"count": c[0], "bytes": c[1]}
                for d, c in sorted(transfers.items())
            },
            "hbm": self.hbm_stats(),
        }

    def reset(self) -> None:
        """Drop everything (tests / bench isolation; on a live server this
        makes the Prometheus counter families go backwards)."""
        with self._lock:
            self._compute = {}
            self._compile = {}
            self._buckets = {}
            self._transfers = {}
            self._sig_costs = {}
            self._flops_measured = {}
            self._drift_warned = set()
            self._started_s = time.monotonic()


# -- SLO engine --------------------------------------------------------------


@dataclass(frozen=True)
class SloObjective:
    """One model's SLO: a p99 latency target and an availability
    objective.  A request is *bad* when it fails outright or lands over
    the latency target; the error budget is ``1 - availability``."""

    p99_ms: float
    availability: float = 0.999

    @property
    def error_budget(self) -> float:
        return max(1e-9, 1.0 - self.availability)


def parse_slo_spec(spec: str) -> Tuple[str, SloObjective]:
    """``--slo MODEL=P99_MS[:AVAILABILITY]`` -> (model, objective).
    Raises ``ValueError`` on junk so a typo'd flag fails at startup."""
    name, sep, rest = spec.partition("=")
    if not sep or not name:
        raise ValueError(
            f"invalid --slo '{spec}': expected MODEL=P99_MS[:AVAILABILITY]")
    target, _, avail = rest.partition(":")
    try:
        p99_ms = float(target)
    except ValueError:
        raise ValueError(f"invalid --slo '{spec}': P99_MS must be a number")
    if p99_ms <= 0:
        raise ValueError(f"invalid --slo '{spec}': P99_MS must be positive")
    availability = 0.999
    if avail:
        try:
            availability = float(avail)
        except ValueError:
            raise ValueError(
                f"invalid --slo '{spec}': AVAILABILITY must be a number")
        if not 0.0 < availability < 1.0:
            raise ValueError(
                f"invalid --slo '{spec}': AVAILABILITY must be in (0, 1)")
    return name, SloObjective(p99_ms=p99_ms, availability=availability)


class _SloWindow:
    """Time-bucketed good/bad counts spanning the longest burn window.

    ``BUCKET_S``-wide buckets in a deque; observing and querying both
    prune buckets past the horizon.  All math takes an explicit ``now`` so
    tests drive synthetic time."""

    BUCKET_S = 10.0

    __slots__ = ("buckets",)

    def __init__(self) -> None:
        # [bucket_start_s, total, bad]
        self.buckets: deque = deque()

    def observe(self, bad: bool, now: float) -> None:
        start = now - (now % self.BUCKET_S)
        if self.buckets and self.buckets[-1][0] == start:
            b = self.buckets[-1]
        else:
            b = [start, 0, 0]
            self.buckets.append(b)
        b[1] += 1
        if bad:
            b[2] += 1
        self._prune(now)

    def _prune(self, now: float) -> None:
        horizon = now - max(SLO_WINDOWS.values()) - self.BUCKET_S
        while self.buckets and self.buckets[0][0] < horizon:
            self.buckets.popleft()

    def counts(self, window_s: float, now: float) -> Tuple[int, int]:
        """(total, bad) over the trailing ``window_s``."""
        horizon = now - window_s
        total = bad = 0
        for start, t, b in self.buckets:
            # a bucket belongs to the window when any of it overlaps
            if start + self.BUCKET_S > horizon and start <= now:
                total += t
                bad += b
        return total, bad


class SloEngine:
    """Multi-window burn-rate evaluation over per-model SLO objectives.

    Objectives come from explicit configuration (the ``--slo`` CLI /
    ``set_objective``) or lazily from a ``resolver`` callback (the core
    installs one reading the model config's ``slo.p99_ms`` /
    ``slo.availability`` parameters); resolved values are cached until
    :meth:`invalidate` (model reload).  Models with no objective are
    ignored entirely — the engine observes nothing for them."""

    def __init__(self,
                 burn_threshold: float = DEFAULT_BURN_THRESHOLD) -> None:
        self.burn_threshold = float(burn_threshold)
        self._lock = threading.Lock()
        self._objectives: Dict[str, SloObjective] = {}
        self._resolved: Dict[str, Optional[SloObjective]] = {}
        self._windows: Dict[str, _SloWindow] = {}
        self.resolver: Optional[
            Callable[[str], Optional[SloObjective]]] = None
        # requests pinned into the flight recorder by a breach, per model
        self.breach_pins: Dict[str, int] = {}

    # -- configuration -----------------------------------------------------
    def set_objective(self, model: str, objective: SloObjective) -> None:
        with self._lock:
            self._objectives[model] = objective
            self._resolved.pop(model, None)

    def invalidate(self, model: str) -> None:
        """Drop the resolver cache for a reloaded model (its config
        parameters may have changed); explicit objectives stay."""
        with self._lock:
            self._resolved.pop(model, None)

    def objective_for(self, model: str) -> Optional[SloObjective]:
        with self._lock:
            obj = self._objectives.get(model)
            if obj is not None:
                return obj
            if model in self._resolved:
                return self._resolved[model]
            resolver = self.resolver
        # resolve OUTSIDE the lock (the resolver may take registry locks)
        obj = resolver(model) if resolver is not None else None
        with self._lock:
            # explicit config set while we resolved wins
            explicit = self._objectives.get(model)
            if explicit is not None:
                return explicit
            self._resolved[model] = obj
        return obj

    # -- observation -------------------------------------------------------
    def observe(self, model: str, total_us: float, ok: bool,
                now: Optional[float] = None) -> bool:
        """Feed one completed request; returns True when the request is
        SLO-bad AND the model is currently breaching — the flight
        recorder's cue to pin this request's span tree."""
        obj = self.objective_for(model)
        if obj is None:
            return False
        now = time.monotonic() if now is None else now
        bad = (not ok) or total_us > obj.p99_ms * 1000.0
        with self._lock:
            w = self._windows.get(model)
            if w is None:
                w = self._windows.setdefault(model, _SloWindow())
            w.observe(bad, now)
        if not bad:
            return False
        if not self.breached(model, now):
            return False
        with self._lock:
            self.breach_pins[model] = self.breach_pins.get(model, 0) + 1
        return True

    # -- evaluation --------------------------------------------------------
    def burn_rate(self, model: str, window_s: float,
                  now: Optional[float] = None) -> Optional[float]:
        """``observed_bad_fraction / error_budget`` over the window; None
        with no objective or no window traffic.  1.0 means the budget is
        being consumed exactly at the sustainable rate."""
        obj = self.objective_for(model)
        if obj is None:
            return None
        now = time.monotonic() if now is None else now
        with self._lock:
            w = self._windows.get(model)
            if w is None:
                return None
            total, bad = w.counts(window_s, now)
        if not total:
            return None
        return (bad / total) / obj.error_budget

    def budget_remaining(self, model: str,
                         now: Optional[float] = None) -> Optional[float]:
        """Error-budget fraction left over the long (1h) window: 1.0 with
        a clean window, 0.0 when the window's bad fraction equals the
        budget, negative when overdrawn (visible, not clamped)."""
        burn = self.burn_rate(model, max(SLO_WINDOWS.values()), now)
        if burn is None:
            return None
        return 1.0 - burn

    def breached(self, model: str, now: Optional[float] = None) -> bool:
        """Multi-window verdict: burning above threshold on BOTH the short
        and the long window."""
        now = time.monotonic() if now is None else now
        for window_s in SLO_WINDOWS.values():
            burn = self.burn_rate(model, window_s, now)
            if burn is None or burn < self.burn_threshold:
                return False
        return True

    # -- export ------------------------------------------------------------
    def metric_rows(self, now: Optional[float] = None) -> Dict[str, list]:
        """``nv_slo_*`` sample rows keyed by short family name."""
        now = time.monotonic() if now is None else now
        with self._lock:
            models = sorted(self._windows)
            pins = dict(self.breach_pins)
        # the threshold is exported so dashboards (a console's breach
        # marker) evaluate the SAME page condition a non-default
        # --slo-burn-threshold server pins on
        rows: Dict[str, list] = {"burn_rate": [], "budget_remaining": [],
                                 "breach_pins": [],
                                 "burn_threshold": [({}, self.burn_threshold)]}
        for m in models:
            for label, window_s in sorted(SLO_WINDOWS.items()):
                burn = self.burn_rate(m, window_s, now)
                if burn is not None:
                    rows["burn_rate"].append(
                        ({"model": m, "window": label}, round(burn, 4)))
            remaining = self.budget_remaining(m, now)
            if remaining is not None:
                rows["budget_remaining"].append(
                    ({"model": m}, round(remaining, 4)))
        for m, n in sorted(pins.items()):
            rows["breach_pins"].append(({"model": m}, n))
        return rows

    def snapshot(self, model: Optional[str] = None,
                 now: Optional[float] = None) -> Dict[str, Any]:
        """Per-model SLO state for the debug surface."""
        now = time.monotonic() if now is None else now
        with self._lock:
            models = sorted(self._windows)
            pins = dict(self.breach_pins)
        out: Dict[str, Any] = {}
        for m in models:
            if model is not None and m != model:
                continue
            obj = self.objective_for(m)
            if obj is None:
                continue
            windows = {}
            with self._lock:
                w = self._windows.get(m)
                counts = {label: w.counts(sec, now)
                          for label, sec in SLO_WINDOWS.items()} if w else {}
            for label, (total, bad) in sorted(counts.items()):
                burn = ((bad / total) / obj.error_budget
                        if total else None)
                windows[label] = {
                    "total": total, "bad": bad,
                    "burn_rate": round(burn, 4) if burn is not None else None,
                }
            remaining = self.budget_remaining(m, now)
            out[m] = {
                "objective": {"p99_ms": obj.p99_ms,
                              "availability": obj.availability},
                "windows": windows,
                "budget_remaining": (round(remaining, 4)
                                     if remaining is not None else None),
                "breached": self.breached(m, now),
                "breach_pins": pins.get(m, 0),
            }
        return {"burn_threshold": self.burn_threshold, "models": out}

    def reset(self) -> None:
        with self._lock:
            self._windows = {}
            self.breach_pins = {}
