"""Prometheus metrics exposition of the port's server (``GET /metrics``).

The port's copy of ``triton_client_tpu/server/metrics.py``: every family is
declared once, in :func:`collect_families`, as ``(name, help, type,
[(labels, value), ...])``, and both surfaces render from it:
:func:`render_prometheus` (the text exposition) and :func:`snapshot` (the
same as JSON).  Names and labels are the reference's, the ``nv_tpu_*``
device family included (kept for the reference's dashboards; on the port
it describes the CUDA card).

The families whose sources this port has: the per-model inference
counters and the pending gauge, the flight recorder's watchdog counters,
deadline drops and chaos injections, the QoS families (sheds by model,
tenant and tier, requests by tenant and tier, lane depths), the device and
scheduler family (``nv_tpu_*``, ``device_stats.py``), the memory governor
(``nv_mem_*``), the SLO burn rates (``nv_slo_*``) and the cost ledger
(``nv_cost_*``).  The reference's other families are absent, not zero,
until their sources are ported: :data:`UNPORTED_FAMILIES` lists each with
its ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from .._telemetry import escape_label as _escape_label
from .core import InferenceCore

#: One declared family: (name, help text, type, [(labels, value), ...]).
Family = Tuple[str, str, str, List[Tuple[Dict[str, str], Any]]]

#: the reference's families whose source is not ported yet -> the ROADMAP
#: item that brings it
UNPORTED_FAMILIES: Dict[str, str] = {
    **{name: "A6b (fleet)" for name in ('nv_fleet_instances', 'nv_fleet_serving_version', 'nv_fleet_scale_total', 'nv_fleet_rolling_update_total', 'nv_fleet_worker_restart_total')},
    **{name: "A6b (the host profiler and incidents)" for name in ('nv_host_loop_lag_us', 'nv_host_gc_pause_us_total', 'nv_host_profile_samples_total', 'nv_host_incident_total')},
    **{name: "A6b (OTLP export)" for name in (
        "nv_otlp_export_total", "nv_otlp_dropped_total")},
    **{name: "A6b (the response cache)" for name in (
        "nv_cache_num_hits_per_model", "nv_cache_num_misses_per_model",
        "nv_cache_num_evictions_per_model")},
    **{name: "A7b (the prefix/KV cache and device faults)"
       for name in ('nv_cache_hit_total', 'nv_cache_miss_total', 'nv_cache_evict_total', 'nv_cache_hit_tokens_total', 'nv_cache_pinned_bytes') + ('nv_device_fault_total', 'nv_device_recovered_sequences_total', 'nv_device_aborted_sequences_total', 'nv_device_quarantine')},
}

_COUNTERS: List[Tuple[str, str, str]] = [
    # (metric name, help text, ModelStats-derived key)
    ("nv_inference_request_success",
     "Number of successful inference requests, all batch sizes", "success"),
    ("nv_inference_request_failure",
     "Number of failed inference requests, all batch sizes", "fail"),
    ("nv_inference_count",
     "Number of inferences performed (batched requests count once per "
     "batch element)", "count"),
    ("nv_inference_exec_count",
     "Number of model executions performed", "exec"),
    ("nv_inference_request_duration_us",
     "Cumulative inference request duration in microseconds", "request_us"),
    ("nv_inference_queue_duration_us",
     "Cumulative inference queuing duration in microseconds", "queue_us"),
    ("nv_inference_compute_infer_duration_us",
     "Cumulative compute inference duration in microseconds", "infer_us"),
    ("nv_inference_batch_size_total",
     "Cumulative batch size of dynamic-batcher executions "
     "(unpadded elements)", "batch_size"),
    ("nv_inference_batch_execution_count",
     "Number of dynamic-batcher executions", "batch_exec"),
]

_GAUGES: List[Tuple[str, str, str]] = [
    ("nv_inference_pending_request_count",
     "Number of inference requests currently executing or awaiting "
     "execution", "pending"),
]

#: ``nv_tpu_*`` family declarations, keyed by the short row name
#: ``DeviceStatsCollector.metric_rows`` emits.
_DEVICE_FAMILIES: List[Tuple[str, str, str, str]] = [
    # (row key, metric name, type, help)
    ("duty_cycle", "nv_tpu_duty_cycle", "gauge",
     "Fraction of the sliding window spent inside COMPUTE windows per "
     "model (pipelined overlap clamps at 1.0)"),
    ("live_mfu", "nv_tpu_live_mfu", "gauge",
     "Windowed model FLOPs utilization: analytic FLOPs per executed "
     "batch over elapsed compute time over chip peak"),
    ("compile_total", "nv_tpu_compile_total", "counter",
     "Number of first executions of a new input-shape signature (the "
     "counted execution) per model"),
    ("compile_us", "nv_tpu_compile_duration_us", "counter",
     "Cumulative compute time of first-signature executions in "
     "microseconds"),
    ("jit_hit", "nv_tpu_jit_cache_hit_total", "counter",
     "Number of executions of an input-shape signature already seen"),
    ("jit_miss", "nv_tpu_jit_cache_miss_total", "counter",
     "Number of executions of a new input-shape signature"),
    ("transfer_total", "nv_tpu_transfer_total", "counter",
     "Number of host<->device transfers (readback drains of outputs) "
     "by direction"),
    ("transfer_bytes", "nv_tpu_transfer_bytes_total", "counter",
     "Cumulative host<->device transfer bytes by direction"),
    ("tick_total", "nv_tpu_tick_total", "counter",
     "Number of dynamic-batcher ticks (batched executions) per model and "
     "bucket"),
    ("tick_batch", "nv_tpu_tick_batch_total", "counter",
     "Cumulative real (unpadded) batch elements executed per model and "
     "bucket"),
    ("tick_padded", "nv_tpu_tick_padded_total", "counter",
     "Cumulative padded batch elements executed per model and bucket"),
    ("tick_assembly_us", "nv_tpu_tick_assembly_duration_us", "counter",
     "Cumulative tick assembly (concat + pad-to-bucket) time in "
     "microseconds per model and bucket"),
    ("tick_queue_depth", "nv_tpu_tick_queue_depth_total", "counter",
     "Cumulative queue depth observed at tick assembly per model and "
     "bucket (divide by nv_tpu_tick_total for the average)"),
    ("tick_syncs", "nv_tpu_tick_sync_total", "counter",
     "Cumulative host<->device synchronization points paid by batcher "
     "ticks per model and bucket"),
    ("tick_steps", "nv_tpu_tick_step_total", "counter",
     "Cumulative device steps fused into batcher/decode ticks per model "
     "and bucket (divide by nv_tpu_tick_total for steps per dispatch)"),
    ("tick_uploads", "nv_tpu_tick_upload_total", "counter",
     "Cumulative host->device control-state uploads paid by decode "
     "ticks per model and bucket (0 on the steady-state generation "
     "fast path)"),
    ("pad_waste", "nv_tpu_pad_waste_ratio", "gauge",
     "Cumulative padded-but-unused fraction of executed batch slots per "
     "model and bucket"),
    ("roofline_ai", "nv_tpu_roofline_arithmetic_intensity", "gauge",
     "Counted arithmetic intensity (FLOPs per byte accessed) "
     "per model and bucket — compare against the chip ridge point "
     "(TRITON_TPU_PEAK_FLOPS / TRITON_TPU_PEAK_BYTES_PER_S)"),
    ("roofline_pct", "nv_tpu_roofline_pct_of_peak", "gauge",
     "Achieved percent of the bound resource's peak (peak FLOP/s when "
     "compute_bound, peak bytes/s when memory_bound) per model and "
     "bucket, with the roofline verdict as a label"),
    ("mem_used", "nv_tpu_memory_used_bytes", "gauge",
     "Device memory bytes currently allocated to tensors"),
    ("mem_peak", "nv_tpu_memory_peak_bytes", "gauge",
     "Peak device memory bytes allocated to tensors since process "
     "start"),
    ("mem_limit", "nv_tpu_memory_limit_bytes", "gauge",
     "Device memory capacity of the card"),
]

#: ``nv_mem_*`` family declarations, keyed by the row names
#: ``MemoryGovernor.metric_rows`` emits (``memory.py``).
_MEM_FAMILIES: List[Tuple[str, str, str, str]] = [
    ("inflight", "nv_mem_inflight_bytes", "gauge",
     "Queued + in-flight request/response payload bytes currently held "
     "per model in the memory governor's ledger"),
    ("budget", "nv_mem_budget_bytes", "gauge",
     "Live host byte budget admission is gated against (--mem-budget-"
     "bytes scaled by any active mem_pressure chaos window; absent when "
     "unbounded)"),
    ("shed", "nv_mem_shed_total", "counter",
     "Requests shed by the memory governor per model, tenant, tier and "
     "reason (host = byte budget, hbm = projected-KV headroom gate)"),
    ("hbm_headroom", "nv_mem_hbm_headroom_bytes", "gauge",
     "Device memory headroom per device (the card's free bytes plus "
     "the caching allocator's reserved-but-unallocated bytes) — the "
     "budget slot admission projects bytes against"),
    ("kv_pinned", "nv_mem_kv_pinned_bytes", "gauge",
     "KV-cache bytes currently pinned by admitted generation slots per "
     "model (the governor's live pin ledger; byte-seconds accrue in "
     "nv_cost_kv_byte_seconds_total)"),
    ("cache_pinned", "nv_mem_cache_pinned_bytes", "gauge",
     "Prefix/KV-cache block bytes currently pinned in device memory per "
     "model — the cache's named reservation in the memory governor's "
     "ledger (byte-seconds accrue to the pinning tenant in "
     "nv_cost_kv_byte_seconds_total at eviction)"),
]

#: ``nv_cost_*`` family declarations, keyed by ``CostLedger.metric_rows``.
_COST_FAMILIES: List[Tuple[str, str, str, str]] = [
    ("device_us", "nv_cost_device_us_total", "counter",
     "Attributed device-time in microseconds per model and tenant (each "
     "request's slot-share of its batch's compute window; sums to the "
     "duty-cycle compute window)"),
    ("flops", "nv_cost_flops_total", "counter",
     "Attributed FLOPs per model and tenant (slot-share of the "
     "signature's counted FLOPs; absent when the count is "
     "unavailable, never fabricated)"),
    ("tokens", "nv_cost_tokens_total", "counter",
     "Generated tokens attributed per model and tenant by the decode "
     "worker"),
    ("kv_byte_seconds", "nv_cost_kv_byte_seconds_total", "counter",
     "KV-cache byte-seconds attributed per model and tenant (pinned "
     "bytes integrated over each generation slot's admit..release "
     "lifetime; reconciles with the memory governor's pin ledger)"),
]

#: ``nv_slo_*`` family declarations, keyed by ``SloEngine.metric_rows``.
_SLO_FAMILIES: List[Tuple[str, str, str, str]] = [
    ("burn_rate", "nv_slo_burn_rate", "gauge",
     "SLO error-budget burn rate (observed bad fraction over error "
     "budget) per model and window; 1.0 consumes the budget exactly at "
     "the sustainable rate"),
    ("budget_remaining", "nv_slo_budget_remaining", "gauge",
     "SLO error-budget fraction remaining over the long window per model "
     "(negative = overdrawn)"),
    ("breach_pins", "nv_slo_breach_total", "counter",
     "Number of SLO-bad requests pinned into the flight recorder while "
     "their model was breaching its multi-window burn threshold"),
    ("burn_threshold", "nv_slo_burn_threshold", "gauge",
     "Configured multi-window breach threshold: a model breaches when "
     "both the 5m and 1h burn rates exceed this"),
]


def collect_families(core: InferenceCore) -> List[Family]:
    """Every server metric family of the port, declared once."""
    keys = [key for _, _, key in _COUNTERS] + [key for _, _, key in _GAUGES]
    rows: Dict[str, List[Tuple[Dict[str, str], Any]]] = \
        {key: [] for key in keys}
    for m in core.registry.models():
        s = m.stats
        with s.lock:
            values = {
                "success": s.success_count,
                "fail": s.fail_count,
                "count": s.inference_count,
                "exec": s.execution_count,
                "request_us": s.success_ns // 1000,
                "queue_us": s.queue_ns // 1000,
                "infer_us": s.infer_ns // 1000,
                "batch_size": s.batch_size_total,
                "batch_exec": s.batch_execution_count,
                "pending": s.pending_count,
            }
        labels = {"model": m.name, "version": m.served_version}
        for key, value in values.items():
            rows[key].append((labels, value))

    families: List[Family] = []
    for name, help_text, key in _COUNTERS:
        families.append((name, help_text, "counter", rows[key]))
    for name, help_text, key in _GAUGES:
        families.append((name, help_text, "gauge", rows[key]))

    # the flight recorder's watchdog: slow (beyond the capture threshold)
    # and captured (pinned with a full span tree), copied under its lock
    slow_by_model, captured_by_model = \
        core.flight_recorder.watchdog_counters()
    with core._counts_lock:
        deadline_by_model = dict(core.deadline_exceeded_by_model)
    by_model = [
        ("nv_inference_slow_request_total",
         "Number of requests that exceeded the flight recorder's "
         "slow-request threshold", slow_by_model),
        ("nv_flight_recorder_captured_total",
         "Number of requests pinned into the flight recorder's outlier "
         "buffer (slow or failed) with a full span tree",
         captured_by_model),
        ("nv_inference_deadline_exceeded_total",
         "Number of inference requests dropped because their deadline "
         "expired before execution", deadline_by_model),
    ]
    if core.chaos is not None:
        by_model.append(
            ("nv_chaos_injected_total",
             "Number of faults injected by the chaos harness",
             core.chaos.counters()))
    for name, help_text, counts in by_model:
        families.append((name, help_text, "counter",
                         [({"model": model}, value)
                          for model, value in sorted(counts.items())]))

    # QoS: sheds by (model, tenant, tier), requests by (tenant, tier), the
    # batchers' lane depths
    families.append((
        "nv_inference_rejected_total",
        "Number of inference requests shed by admission control (tenant "
        "rate limit, tier queue threshold, or lower-tier preemption)",
        "counter",
        [({"model": model, "tenant": tenant, "tier": str(tier)}, value)
         for (model, tenant, tier), value in sorted(
             core.qos.rejected_counts().items())]))
    families.append((
        "nv_qos_tenant_requests_total",
        "Number of inference requests per tenant and QoS tier (admitted "
        "or shed)", "counter",
        [({"tenant": tenant, "tier": str(tier)}, value)
         for (tenant, tier), value in sorted(
             core.qos.tenant_request_counts().items())]))
    families.append((
        "nv_qos_queue_depth",
        "Requests currently queued in the dynamic batcher per model and "
        "QoS tier", "gauge",
        [({"model": model, "tier": str(tier)}, value)
         for (model, tier), value in sorted(
             core.qos_queue_depths().items())]))

    device_rows = core.device_stats.metric_rows()
    for key, name, kind, help_text in _DEVICE_FAMILIES:
        families.append((name, help_text, kind, device_rows.get(key, [])))
    mem_rows = core.memory.metric_rows()
    for key, name, kind, help_text in _MEM_FAMILIES:
        families.append((name, help_text, kind, mem_rows.get(key, [])))
    slo_rows = core.slo.metric_rows()
    for key, name, kind, help_text in _SLO_FAMILIES:
        families.append((name, help_text, kind, slo_rows.get(key, [])))
    cost_rows = core.cost_ledger.metric_rows()
    for key, name, kind, help_text in _COST_FAMILIES:
        families.append((name, help_text, kind, cost_rows.get(key, [])))
    return families


def _render_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                     for k, v in labels.items())
    return "{" + inner + "}"


def render_prometheus(core: InferenceCore) -> str:
    """Every family in the Prometheus text exposition format."""
    lines: List[str] = []
    for name, help_text, kind, rows in collect_families(core):
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {kind}")
        for labels, value in rows:
            lines.append(f"{name}{_render_labels(labels)} {value}")
    return "\n".join(lines) + "\n"


def snapshot(core: InferenceCore) -> Dict[str, Any]:
    """The same families as JSON: ``{family: {"help", "type", "samples":
    [{"labels": {...}, "value": v}]}}``."""
    return {
        name: {
            "help": help_text,
            "type": kind,
            "samples": [{"labels": dict(labels), "value": value}
                        for labels, value in rows],
        }
        for name, help_text, kind, rows in collect_families(core)
    }
