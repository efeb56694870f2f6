"""A top(1)-style live console for a running server of the port.

The port's counterpart of ``triton_client_tpu/tools/top.py``: the same
parsers, rows, fleet aggregation and rendered tables, so a server read by
either console reads the same.  It polls two HTTP surfaces of the port's
server -- ``GET /metrics`` (the ``nv_inference_*`` counters and the
device, QoS, cost, memory, fleet, host and cache families) and ``GET
/v2/debug/flight_recorder`` (the flight recorder's live per-model
quantiles and pinned outliers) -- and renders one refreshing per-model
table: QPS, p50/p99, queue share, realized batch, in-flight requests,
error rate, watchdog counters, device duty cycle, the memory-governor
columns (MEM% = the model's share of the live byte budget, SHED/s = its
memory-shed rate), the fleet columns (INST = live batcher instances, VER =
the version unversioned traffic routes to), the SLO burn rate (``!`` when
both the 5m and 1h windows burn over the server's threshold, ``^`` / ``v``
when the autoscaler scaled out / in since the previous poll), the
supervisor's worker-restart count (``nv_fleet_worker_restart_total``) in
the header and the most recent pinned outlier; plus a buckets view
whenever the server exports ``nv_tpu_tick_*`` series, a cost view and a
tenant view::

    python -m triton_client_tpu_torch.tools.top --url localhost:8000
    python -m triton_client_tpu_torch.tools.top --url localhost:8000 --once --json

The port has no console script for it.  The device families keep the
reference's ``nv_tpu_*`` names on the card (ROADMAP C).

Standard library only: the console runs (and ``--help`` exits 0) on a
machine without PyTorch or numpy.

Rates (QPS, error %, queue share, batch) are deltas between consecutive
polls; ``--once`` takes a single sample, so rate columns fall back to the
cumulative counters (and QPS is null in ``--json``).

``--url`` is repeatable: with a fleet, every server is polled each cycle
and the table shows one aggregated row per model (QPS/pending/shed summed
across replicas, latency tails as the WORST replica -- the fleet's honest
tail) with a per-server breakdown row under it; an unreachable replica is
shown as down instead of killing the console.  ``--once --json`` carries
the per-endpoint samples next to the aggregate.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional

#: nv_* families the table consumes (summed across versions per model).
_METRICS = (
    "nv_inference_request_success",
    "nv_inference_request_failure",
    "nv_inference_request_duration_us",
    "nv_inference_queue_duration_us",
    "nv_inference_batch_size_total",
    "nv_inference_batch_execution_count",
    "nv_inference_pending_request_count",
    "nv_inference_rejected_total",
    "nv_inference_deadline_exceeded_total",
)

# greedy label block up to the LAST `}` before the value: a label value
# may contain a literal `}` (tenant ids are client-supplied octets); the
# block is optional — unlabeled gauges (nv_slo_burn_threshold) match with
# a None label group
_SERIES_RE = re.compile(r'^(\w+)(?:\{(.*)\})?\s+([0-9.eE+-]+)\s*$')
_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def _fetch(url: str, timeout: float) -> str:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode("utf-8")


def parse_metrics(text: str) -> Dict[str, Dict[str, float]]:
    """Prometheus exposition -> ``{metric: {model: value}}`` for the
    families the table uses, versions summed per model."""
    out: Dict[str, Dict[str, float]] = {m: {} for m in _METRICS}
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        m = _SERIES_RE.match(line)
        if not m:
            continue
        name, labels_raw, value = m.groups()
        if name not in out:
            continue
        labels = dict(_LABEL_RE.findall(labels_raw or ""))
        model = labels.get("model", "")
        if not model:
            continue
        out[name][model] = out[name].get(model, 0.0) + float(value)
    return out


#: nv_tpu_tick_* families folded into the buckets view, keyed by the
#: short field name the rows use.
_BUCKET_METRICS = {
    "nv_tpu_tick_total": "ticks",
    "nv_tpu_tick_batch_total": "batch",
    "nv_tpu_tick_padded_total": "padded",
    "nv_tpu_tick_assembly_duration_us": "assembly_us",
    "nv_tpu_tick_queue_depth_total": "queue_depth",
    "nv_tpu_tick_sync_total": "syncs",
    "nv_tpu_tick_step_total": "steps",
    "nv_tpu_tick_upload_total": "uploads",
}


def parse_device(text: str) -> Dict[str, Any]:
    """Device/SLO/fleet series -> ``{"duty": {model: v}, "mfu": {model:
    v}, "burn": {(model, window): v}, "burn_threshold": v, "buckets":
    {(model, bucket): {field: v}}, "inst": {model: v}, "ver": {model:
    v}, "scale": {(model, direction): v}, "restarts": {worker: v}}``.
    Servers predating the device-stats or fleet layers simply produce
    empty maps (and the default threshold)."""
    out: Dict[str, Any] = {"duty": {}, "mfu": {}, "burn": {}, "buckets": {},
                           "burn_threshold": 14.4,
                           "inst": {}, "ver": {}, "scale": {},
                           "restarts": {},
                           "mem_inflight": {}, "mem_budget": None,
                           "mem_shed": {},
                           "host_lag_us": None, "host_gc_us": None,
                           "fault": {}, "quar": {},
                           "cache_hit": {}, "cache_miss": {},
                           "cache_pinned": {}}
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        m = _SERIES_RE.match(line)
        if not m:
            continue
        name, labels_raw, value = m.groups()
        if name == "nv_slo_burn_threshold":
            # the server's configured page condition — the "!" breach
            # marker must agree with a non-default --slo-burn-threshold
            out["burn_threshold"] = float(value)
            continue
        if name == "nv_mem_budget_bytes":
            # unlabeled live-budget gauge (shrinks under mem_pressure
            # chaos) — the MEM% column's denominator
            out["mem_budget"] = float(value)
            continue
        if name == "nv_host_loop_lag_us":
            # per-loop gauges fold to the WORST loop — the stall an
            # operator chases is on whichever frontend loop has it
            v = float(value)
            if out["host_lag_us"] is None or v > out["host_lag_us"]:
                out["host_lag_us"] = v
            continue
        if name == "nv_host_gc_pause_us_total":
            # summed over generations: the GC column answers "how much
            # wall time does GC steal", not which generation stole it
            out["host_gc_us"] = (out["host_gc_us"] or 0.0) + float(value)
            continue
        if name == "nv_fleet_worker_restart_total":
            # kept per worker: every worker of one supervised fleet
            # exports the SAME fleet-global counters (shared state
            # file), so the fleet view must dedup per worker across
            # polled endpoints, not sum endpoints
            labels = dict(_LABEL_RE.findall(labels_raw or ""))
            worker = labels.get("worker", "")
            out["restarts"][worker] = (out["restarts"].get(worker, 0.0)
                                       + float(value))
            continue
        if name not in ("nv_tpu_duty_cycle", "nv_tpu_live_mfu",
                        "nv_slo_burn_rate", "nv_fleet_instances",
                        "nv_fleet_serving_version", "nv_fleet_scale_total",
                        "nv_mem_inflight_bytes", "nv_mem_shed_total",
                        "nv_tpu_roofline_arithmetic_intensity",
                        "nv_tpu_roofline_pct_of_peak",
                        "nv_device_fault_total", "nv_device_quarantine",
                        "nv_cache_hit_total", "nv_cache_miss_total",
                        "nv_cache_pinned_bytes"
                        ) and name not in _BUCKET_METRICS:
            continue
        labels = dict(_LABEL_RE.findall(labels_raw or ""))
        model = labels.get("model", "")
        if not model:
            continue
        if name == "nv_tpu_duty_cycle":
            out["duty"][model] = float(value)
        elif name == "nv_tpu_live_mfu":
            out["mfu"][model] = float(value)
        elif name == "nv_slo_burn_rate":
            out["burn"][(model, labels.get("window", ""))] = float(value)
        elif name == "nv_fleet_instances":
            out["inst"][model] = float(value)
        elif name == "nv_fleet_serving_version":
            out["ver"][model] = float(value)
        elif name == "nv_fleet_scale_total":
            key = (model, labels.get("direction", ""))
            out["scale"][key] = out["scale"].get(key, 0.0) + float(value)
        elif name == "nv_mem_inflight_bytes":
            out["mem_inflight"][model] = float(value)
        elif name == "nv_mem_shed_total":
            # summed over (tenant, tier, reason): the SHED/s column is
            # per model; the reason split stays on the metrics surface
            out["mem_shed"][model] = (out["mem_shed"].get(model, 0.0)
                                      + float(value))
        elif name == "nv_device_fault_total":
            # summed over fault kinds: the FAULT column answers "is this
            # model's device faulting"; the kind split stays on /metrics
            out["fault"][model] = (out["fault"].get(model, 0.0)
                                   + float(value))
        elif name == "nv_device_quarantine":
            out["quar"][model] = float(value)
        elif name == "nv_cache_hit_total":
            # prefix/KV block cache (server/kvcache.py) — NOT the
            # response cache's nv_cache_num_*_per_model families
            out["cache_hit"][model] = float(value)
        elif name == "nv_cache_miss_total":
            out["cache_miss"][model] = float(value)
        elif name == "nv_cache_pinned_bytes":
            out["cache_pinned"][model] = float(value)
        elif name == "nv_tpu_roofline_arithmetic_intensity":
            # gauges, not counters: the buckets view shows the current
            # value, never a delta
            entry = out["buckets"].setdefault(
                (model, labels.get("bucket", "")), {})
            entry["roofline_ai"] = float(value)
        elif name == "nv_tpu_roofline_pct_of_peak":
            entry = out["buckets"].setdefault(
                (model, labels.get("bucket", "")), {})
            entry["roofline_pct"] = float(value)
            entry["roofline_verdict"] = labels.get("verdict", "")
        else:
            bucket = labels.get("bucket", "")
            entry = out["buckets"].setdefault((model, bucket), {})
            entry[_BUCKET_METRICS[name]] = entry.get(
                _BUCKET_METRICS[name], 0.0) + float(value)
    return out


def parse_qos(text: str) -> Dict[str, Dict[tuple, float]]:
    """Tenant/tier-labeled QoS series -> ``{"requests": {(tenant, tier):
    v}, "shed": {(tenant, tier): v}}`` (shed summed over models).  Servers
    predating the QoS layer simply produce empty maps."""
    out: Dict[str, Dict[tuple, float]] = {"requests": {}, "shed": {}}
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        m = _SERIES_RE.match(line)
        if not m:
            continue
        name, labels_raw, value = m.groups()
        if name == "nv_qos_tenant_requests_total":
            bucket = out["requests"]
        elif name == "nv_inference_rejected_total":
            bucket = out["shed"]
        else:
            continue
        labels = dict(_LABEL_RE.findall(labels_raw or ""))
        tenant = labels.get("tenant")
        if tenant is None:
            continue  # pre-QoS model-only series
        key = (tenant, labels.get("tier", "0"))
        bucket[key] = bucket.get(key, 0.0) + float(value)
    return out


#: nv_cost_* families folded into the COST view, keyed by the short
#: field name the rows use.
_COST_METRICS = {
    "nv_cost_device_us_total": "device_us",
    "nv_cost_flops_total": "flops",
    "nv_cost_tokens_total": "tokens",
    "nv_cost_kv_byte_seconds_total": "kv_byte_seconds",
}


def parse_costs(text: str) -> Dict[tuple, Dict[str, float]]:
    """Per-tenant cost-attribution series -> ``{(model, tenant):
    {field: v}}``.  Servers predating the cost ledger simply produce an
    empty map."""
    out: Dict[tuple, Dict[str, float]] = {}
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        m = _SERIES_RE.match(line)
        if not m:
            continue
        name, labels_raw, value = m.groups()
        field = _COST_METRICS.get(name)
        if field is None:
            continue
        labels = dict(_LABEL_RE.findall(labels_raw or ""))
        key = (labels.get("model", ""), labels.get("tenant", ""))
        entry = out.setdefault(key, {})
        entry[field] = entry.get(field, 0.0) + float(value)
    return out


def sample(base_url: str, timeout: float, limit: int = 0) -> Dict[str, Any]:
    """One poll of both surfaces, monotonic-stamped for rate deltas."""
    recorder_url = f"{base_url}/v2/debug/flight_recorder"
    if limit:
        recorder_url += f"?limit={int(limit)}"
    metrics_text = _fetch(f"{base_url}/metrics", timeout)
    return {
        "t": time.monotonic(),
        "metrics": parse_metrics(metrics_text),
        "qos": parse_qos(metrics_text),
        "device": parse_device(metrics_text),
        "costs": parse_costs(metrics_text),
        "recorder": json.loads(_fetch(recorder_url, timeout)),
    }


def _delta(cur: Dict[str, Dict[str, float]],
           prev: Optional[Dict[str, Dict[str, float]]],
           metric: str, model: str) -> float:
    now = cur.get(metric, {}).get(model, 0.0)
    if prev is None:
        return now  # cumulative fallback for the first/only sample
    d = now - prev.get(metric, {}).get(model, 0.0)
    # a negative delta means the server restarted between polls (its
    # cumulative counters reset): the post-restart cumulative value is
    # the honest frame, not a negative QPS
    return now if d < 0 else d


def model_rows(cur: Dict[str, Any], prev: Optional[Dict[str, Any]],
               include_idle: bool = False) -> Dict[str, Dict[str, Any]]:
    """Fold one (or two, for rates) samples into per-model table rows.
    Models that have never served a request are dropped unless
    ``include_idle`` — a zoo registers dozens of models and the operator
    is looking at the ones taking traffic."""
    metrics = cur["metrics"]
    pmetrics = prev["metrics"] if prev else None
    recorder = cur["recorder"]
    dt = (cur["t"] - prev["t"]) if prev else None
    names = set(recorder.get("models", {}))
    for per_model in metrics.values():
        names.update(m for m, v in per_model.items()
                     if include_idle or v > 0)
    last_outlier: Dict[str, dict] = {}
    for o in recorder.get("outliers", []):
        seen = last_outlier.get(o["model"])
        if seen is None or o["seq"] > seen["seq"]:
            last_outlier[o["model"]] = o
    rows: Dict[str, Dict[str, Any]] = {}
    for model in sorted(names):
        succ = _delta(metrics, pmetrics, "nv_inference_request_success", model)
        fail = _delta(metrics, pmetrics, "nv_inference_request_failure", model)
        req_us = _delta(metrics, pmetrics,
                        "nv_inference_request_duration_us", model)
        queue_us = _delta(metrics, pmetrics,
                          "nv_inference_queue_duration_us", model)
        batch_total = _delta(metrics, pmetrics,
                             "nv_inference_batch_size_total", model)
        batch_exec = _delta(metrics, pmetrics,
                            "nv_inference_batch_execution_count", model)
        rejected = _delta(metrics, pmetrics,
                          "nv_inference_rejected_total", model)
        deadline_x = _delta(metrics, pmetrics,
                            "nv_inference_deadline_exceeded_total", model)
        total = succ + fail
        rec = recorder.get("models", {}).get(model, {})
        device = cur.get("device") or {}
        pdevice = (prev.get("device") or {}) if prev else None
        duty = device.get("duty", {}).get(model)
        mfu = device.get("mfu", {}).get(model)
        burn5 = device.get("burn", {}).get((model, "5m"))
        burn1h = device.get("burn", {}).get((model, "1h"))
        inst = device.get("inst", {}).get(model)
        ver = device.get("ver", {}).get(model)
        # autoscale-actuation marker: did nv_fleet_scale_total move for
        # this model between polls?  (Needs a delta base — the first/only
        # sample shows no marker rather than re-flagging history.)
        scaled = ""
        if pdevice is not None:
            for direction, mark in (("out", "^"), ("in", "v")):
                d = (device.get("scale", {}).get((model, direction), 0.0)
                     - pdevice.get("scale", {}).get((model, direction), 0.0))
                if d > 0:
                    scaled += mark
        rows[model] = {
            "qps": round(total / dt, 1) if dt else None,
            "p50_ms": rec.get("p50_ms"),
            "p99_ms": rec.get("p99_ms"),
            "queue_share_pct": (round(100.0 * queue_us / req_us, 1)
                                if req_us > 0 else None),
            "batch_avg": (round(batch_total / batch_exec, 1)
                          if batch_exec > 0 else None),
            "pending": int(metrics.get(
                "nv_inference_pending_request_count", {}).get(model, 0)),
            "error_pct": round(100.0 * fail / total, 2) if total > 0 else None,
            # resilience layer: shed + deadline-dropped rates (cumulative
            # counters on the first/only sample, like qps)
            "rejected_per_s": round(rejected / dt, 1) if dt else None,
            "deadline_exceeded_per_s": (round(deadline_x / dt, 1)
                                        if dt else None),
            "slow_total": rec.get("slow_total", 0),
            "captured_total": rec.get("captured_total", 0),
            "threshold_ms": rec.get("threshold_ms"),
            # device/SLO layer (absent on servers predating it)
            "duty_pct": (round(100.0 * duty, 1)
                         if duty is not None else None),
            "mfu_pct": round(100.0 * mfu, 1) if mfu is not None else None,
            # fleet layer: live instance parallelism, serving version,
            # and whether the autoscaler actuated since the last poll
            "instances": int(inst) if inst is not None else None,
            "version": int(ver) if ver is not None else None,
            "scaled": scaled or None,
            # memory governor (server/memory.py): this model's share of
            # the live byte budget, and its memory-shed rate (cumulative
            # on the first/only sample, like the other counters)
            "mem_pct": (round(100.0 * device.get(
                "mem_inflight", {}).get(model, 0.0)
                / device["mem_budget"], 1)
                if device.get("mem_budget") else None),
            "mem_shed_per_s": (round(_mem_shed_delta(
                device, pdevice, model) / dt, 1) if dt
                else device.get("mem_shed", {}).get(model)),
            # host self-observation (server/profiler.py): process-wide
            # values repeated per row — in the fleet view the worst
            # replica's lag and the summed GC rate survive aggregation
            "host_lag_ms": (round(device["host_lag_us"] / 1e3, 2)
                            if device.get("host_lag_us") is not None
                            else None),
            "gc_ms_per_s": _gc_rate(device, pdevice, dt),
            "burn_5m": round(burn5, 1) if burn5 is not None else None,
            "burn_1h": round(burn1h, 1) if burn1h is not None else None,
            # multi-window breach at the server's exported threshold
            # (nv_slo_burn_threshold): both windows burning — the page
            # condition, matching what the server itself pins on
            "slo_breach": (burn5 is not None and burn1h is not None
                           and burn5 >= device.get("burn_threshold", 14.4)
                           and burn1h >= device.get("burn_threshold", 14.4)),
            # device-fault containment: fault rate between polls
            # (cumulative on the first/only sample) and the quarantine
            # flag — QUAR shows the model is refusing with typed 503s
            "fault_per_s": (round(_fault_delta(device, pdevice, model)
                                  / dt, 1) if dt
                            else device.get("fault", {}).get(model)),
            "quarantined": bool(device.get("quar", {}).get(model, 0.0)),
            # prefix/KV block cache (server/kvcache.py): hit ratio over
            # the poll window (cumulative on the first/only sample) and
            # the MB currently pinned by resident blocks.  Raw deltas
            # ride along unrendered so the fleet fold can recompute the
            # ratio from summed counts instead of averaging percentages.
            "cache_hits_d": _cache_delta(device, pdevice, model,
                                         "cache_hit"),
            "cache_lookups_d": (_cache_delta(device, pdevice, model,
                                             "cache_hit")
                                + _cache_delta(device, pdevice, model,
                                               "cache_miss")),
            "hit_pct": _hit_pct(device, pdevice, model),
            "cache_mb": (round(device["cache_pinned"][model] / 1e6, 1)
                         if model in device.get("cache_pinned", {})
                         else None),
            "last_outlier": _outlier_brief(last_outlier.get(model)),
        }
    return rows


def _cache_delta(device: Dict[str, Any], pdevice: Optional[Dict[str, Any]],
                 model: str, key: str) -> float:
    """Prefix-cache counter movement between polls (cumulative fallback
    on the first sample; counter resets clamp at the new value, same
    contract as ``_delta``)."""
    now = (device.get(key) or {}).get(model, 0.0)
    if pdevice is None:
        return now
    d = now - (pdevice.get(key) or {}).get(model, 0.0)
    return now if d < 0 else d


def _hit_pct(device: Dict[str, Any], pdevice: Optional[Dict[str, Any]],
             model: str) -> Optional[float]:
    """HIT% over the poll window: hits / (hits + misses) * 100, None
    when the model took no cache lookups (or predates the cache) — a
    dash is honest where 0.0 would read as "all misses"."""
    hits = _cache_delta(device, pdevice, model, "cache_hit")
    lookups = hits + _cache_delta(device, pdevice, model, "cache_miss")
    if lookups <= 0:
        return None
    return round(100.0 * hits / lookups, 1)


def _fault_delta(device: Dict[str, Any], pdevice: Optional[Dict[str, Any]],
                 model: str) -> float:
    """nv_device_fault_total movement between polls (summed over fault
    kinds; counter-reset clamps at the new value, like ``_delta``)."""
    now = device.get("fault", {}).get(model, 0.0)
    if pdevice is None:
        return now
    d = now - pdevice.get("fault", {}).get(model, 0.0)
    return now if d < 0 else d


def _gc_rate(device: Dict[str, Any], pdevice: Optional[Dict[str, Any]],
             dt: Optional[float]) -> Optional[float]:
    """GC pause milliseconds per second of wall clock between polls
    (cumulative total in ms on the first/only sample; a counter reset
    clamps at the new value, same contract as ``_delta``)."""
    now = device.get("host_gc_us")
    if now is None:
        return None
    if not dt or pdevice is None:
        return round(now / 1e3, 1)
    d = now - (pdevice.get("host_gc_us") or 0.0)
    if d < 0:
        d = now
    return round(d / 1e3 / dt, 2)


def _mem_shed_delta(device: Dict[str, Any],
                    pdevice: Optional[Dict[str, Any]],
                    model: str) -> float:
    """Memory-shed counter movement between polls (cumulative fallback
    on the first sample; post-restart resets clamp at the new value,
    same contract as ``_delta``)."""
    now = (device.get("mem_shed") or {}).get(model, 0.0)
    if pdevice is None:
        return now
    d = now - (pdevice.get("mem_shed") or {}).get(model, 0.0)
    return now if d < 0 else d


def bucket_rows(cur: Dict[str, Any],
                prev: Optional[Dict[str, Any]]) -> Dict[tuple, Dict[str, Any]]:
    """Per-(model, bucket) tick rows — the buckets view (ROADMAP item 2's
    bucket-geometry tuning surface).  Rates are deltas between polls;
    occupancy/pad-waste/assembly columns are averaged over the delta
    window (cumulative on the first/only sample)."""
    device = cur.get("device") or {}
    pdevice = (prev.get("device") or {}) if prev else {}
    dt = (cur["t"] - prev["t"]) if prev else None
    rows: Dict[tuple, Dict[str, Any]] = {}
    for key, cum in sorted(device.get("buckets", {}).items()):
        pcum = pdevice.get("buckets", {}).get(key)

        def delta(field: str) -> float:
            now = cum.get(field, 0.0)
            if pcum is None:
                return now
            d = now - pcum.get(field, 0.0)
            return now if d < 0 else d  # counter reset = server restart

        ticks = delta("ticks")
        batch, padded = delta("batch"), delta("padded")
        rows[key] = {
            "ticks_per_s": round(ticks / dt, 1) if dt else None,
            "ticks": cum.get("ticks", 0.0),
            "avg_batch": round(batch / ticks, 1) if ticks else None,
            "pad_pct": (round(100.0 * (1.0 - batch / padded), 1)
                        if padded else None),
            "avg_assembly_us": (round(delta("assembly_us") / ticks, 1)
                                if ticks else None),
            "avg_queue_depth": (round(delta("queue_depth") / ticks, 1)
                                if ticks else None),
            "syncs_per_tick": (round(delta("syncs") / ticks, 2)
                               if ticks else None),
            # decode fast-path columns: steps fused per dispatch (the T
            # amortization) and host->device control uploads per tick
            # (~0 in steady-state generation)
            "steps_per_tick": (round(delta("steps") / ticks, 2)
                               if ticks else None),
            "uploads_per_tick": (round(delta("uploads") / ticks, 2)
                                 if ticks else None),
            # roofline gauges (the server's cost analysis): current
            # value, not a delta — absent when the server has no analysis
            # for this bucket (never fabricated)
            "roofline_ai": cum.get("roofline_ai"),
            "roofline_pct": cum.get("roofline_pct"),
            "roofline_verdict": cum.get("roofline_verdict"),
        }
    return rows


def aggregate_buckets(per_url: Dict[str, Dict[tuple, Dict[str, Any]]]
                      ) -> Dict[tuple, Dict[str, Any]]:
    """Fleet buckets view: tick rates sum; occupancy/pad/assembly columns
    take the worst replica (the straggler bucket is the tuning target)."""
    agg: Dict[tuple, Dict[str, Any]] = {}
    keys: set = set()
    for rows in per_url.values():
        keys.update(rows)
    for key in sorted(keys):
        rows = [r[key] for r in per_url.values() if key in r]

        def _sum(field, nd=1):
            vals = [r[field] for r in rows if r.get(field) is not None]
            return round(sum(vals), nd) if vals else None

        def _worst(field):
            vals = [r[field] for r in rows if r.get(field) is not None]
            return max(vals) if vals else None

        def _least(field):
            vals = [r[field] for r in rows if r.get(field) is not None]
            return min(vals) if vals else None

        agg[key] = {
            "ticks_per_s": _sum("ticks_per_s"),
            "ticks": sum(r.get("ticks", 0.0) for r in rows),
            "avg_batch": _worst("avg_batch"),
            "pad_pct": _worst("pad_pct"),
            "avg_assembly_us": _worst("avg_assembly_us"),
            "avg_queue_depth": _worst("avg_queue_depth"),
            "syncs_per_tick": _worst("syncs_per_tick"),
            # steps-per-dispatch: the LEAST-amortized replica is the
            # straggler; uploads take the highest replica — any nonzero
            # steady-state value is the regression smell
            "steps_per_tick": _least("steps_per_tick"),
            "uploads_per_tick": _worst("uploads_per_tick"),
            # roofline: AI is a compile-time property (identical across
            # replicas) — any value serves; the achieved %-of-peak takes
            # the worst (hottest) replica, and its verdict rides along
            "roofline_ai": _worst("roofline_ai"),
            "roofline_pct": _worst("roofline_pct"),
            "roofline_verdict": next(
                (r["roofline_verdict"] for r in rows
                 if r.get("roofline_verdict")), None),
        }
    return agg


def tenant_rows(cur: Dict[str, Any],
                prev: Optional[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """Per-tenant QoS rows: request rate plus SHED/s broken down by tier
    (cumulative counters on the first/only sample, like the model rows).
    Empty when the server exposes no tenant-labeled series."""
    qos = cur.get("qos") or {}
    pqos = (prev.get("qos") or {}) if prev else None
    dt = (cur["t"] - prev["t"]) if prev else None

    def delta(kind: str, key: tuple) -> float:
        now = qos.get(kind, {}).get(key, 0.0)
        if pqos is None:
            return now
        d = now - pqos.get(kind, {}).get(key, 0.0)
        return now if d < 0 else d  # counter reset = server restart

    rows: Dict[str, Dict[str, Any]] = {}
    keys = set(qos.get("requests", {})) | set(qos.get("shed", {}))
    for tenant, tier in sorted(keys):
        row = rows.setdefault(tenant, {"req": 0.0, "shed_by_tier": {}})
        row["req"] += delta("requests", (tenant, tier))
        shed = delta("shed", (tenant, tier))
        if shed or (tenant, tier) in qos.get("shed", {}):
            row["shed_by_tier"][tier] = \
                row["shed_by_tier"].get(tier, 0.0) + shed
    for row in rows.values():
        row["req_per_s"] = round(row["req"] / dt, 1) if dt else None
        row["shed_per_s_by_tier"] = {
            t: (round(v / dt, 1) if dt else None)
            for t, v in sorted(row["shed_by_tier"].items())}
    return rows


def aggregate_tenants(per_url: Dict[str, Dict[str, Dict[str, Any]]]
                      ) -> Dict[str, Dict[str, Any]]:
    """Sum per-server tenant rows into fleet rows (all columns additive;
    rate columns sum over the replicas that have a delta base and stay
    None until at least one does — same partial-sum convention as the
    per-model fleet rows)."""
    agg: Dict[str, Dict[str, Any]] = {}
    for rows in per_url.values():
        for tenant, r in rows.items():
            a = agg.setdefault(tenant, {
                "req": 0.0, "shed_by_tier": {},
                "req_per_s": None, "shed_per_s_by_tier": {}})
            a["req"] += r["req"]
            for t, v in r["shed_by_tier"].items():
                a["shed_by_tier"][t] = a["shed_by_tier"].get(t, 0.0) + v
            if r.get("req_per_s") is not None:
                a["req_per_s"] = round(
                    (a["req_per_s"] or 0.0) + r["req_per_s"], 1)
            for t, v in (r.get("shed_per_s_by_tier") or {}).items():
                if v is not None:
                    cur = a["shed_per_s_by_tier"].get(t)
                    a["shed_per_s_by_tier"][t] = round(
                        (cur or 0.0) + v, 1)
    return agg


def _tenant_lines(rows: Dict[str, Dict[str, Any]]) -> List[str]:
    if not rows:
        return []
    rated = any(r.get("req_per_s") is not None for r in rows.values())
    unit = "/s" if rated else " total"
    lines = ["", f"  {'TENANT':<24}{'REQ' + unit:>12}  SHED{unit} by tier"]
    for tenant in sorted(rows):
        r = rows[tenant]
        req = r["req_per_s"] if rated else r["req"]
        shed = (r.get("shed_per_s_by_tier") if rated
                else r["shed_by_tier"]) or {}
        shed_s = "  ".join(
            f"t{t}={_fmt(v)}" for t, v in sorted(shed.items())) or "-"
        lines.append(f"  {tenant:<24}{_fmt(req):>12}  {shed_s}")
    return lines


def cost_rows(cur: Dict[str, Any],
              prev: Optional[Dict[str, Any]]) -> Dict[tuple, Dict[str, Any]]:
    """Per-(model, tenant) cost-attribution rows — the COST view.  Rate
    columns are deltas between polls (cumulative counters on the
    first/only sample); device-time and unit-cost columns derive from
    the same window so they always agree with each other."""
    costs = cur.get("costs") or {}
    pcosts = (prev.get("costs") or {}) if prev else None
    dt = (cur["t"] - prev["t"]) if prev else None
    rows: Dict[tuple, Dict[str, Any]] = {}
    for key, cum in sorted(costs.items()):
        pcum = pcosts.get(key) if pcosts is not None else None

        def delta(field: str) -> float:
            now = cum.get(field, 0.0)
            if pcum is None:
                return now
            d = now - pcum.get(field, 0.0)
            return now if d < 0 else d  # counter reset = server restart

        dev_us, tokens = delta("device_us"), delta("tokens")
        rows[key] = {
            "device_us": round(cum.get("device_us", 0.0), 1),
            "tokens": int(cum.get("tokens", 0.0)),
            "flops": cum.get("flops", 0.0),
            "kv_byte_seconds": round(cum.get("kv_byte_seconds", 0.0), 3),
            # DEVms/s: attributed device-milliseconds per wall second —
            # a tenant's share of the accelerator, directly comparable
            # across tenants and against the duty-cycle column
            "device_ms_per_s": (round(dev_us / dt / 1e3, 2)
                                if dt else None),
            "tokens_per_s": round(tokens / dt, 1) if dt else None,
            "gflops_per_s": (round(delta("flops") / dt / 1e9, 1)
                             if dt else None),
            # unit cost: device-microseconds per generated token over
            # the delta window (the billing-grade efficiency number)
            "us_per_token": (round(dev_us / tokens, 1)
                             if tokens else None),
        }
    return rows


def aggregate_costs(per_url: Dict[str, Dict[tuple, Dict[str, Any]]]
                    ) -> Dict[tuple, Dict[str, Any]]:
    """Sum per-server cost rows into fleet rows (everything here is
    additive work done; rate columns sum over replicas with a delta
    base; unit cost re-derives from the summed window)."""
    agg: Dict[tuple, Dict[str, Any]] = {}
    keys: set = set()
    for rows in per_url.values():
        keys.update(rows)
    for key in sorted(keys):
        rows = [r[key] for r in per_url.values() if key in r]

        def _sum(field, nd=1):
            vals = [r[field] for r in rows if r.get(field) is not None]
            return round(sum(vals), nd) if vals else None

        dev_us = sum(r.get("device_us", 0.0) for r in rows)
        tokens = sum(r.get("tokens", 0) for r in rows)
        agg[key] = {
            "device_us": round(dev_us, 1),
            "tokens": int(tokens),
            "flops": sum(r.get("flops", 0.0) for r in rows),
            "kv_byte_seconds": round(
                sum(r.get("kv_byte_seconds", 0.0) for r in rows), 3),
            "device_ms_per_s": _sum("device_ms_per_s", nd=2),
            "tokens_per_s": _sum("tokens_per_s"),
            "gflops_per_s": _sum("gflops_per_s"),
            "us_per_token": (round(dev_us / tokens, 1)
                             if tokens else None),
        }
    return agg


def _cost_lines(rows: Dict[tuple, Dict[str, Any]]) -> List[str]:
    """The COST view: one line per (model, tenant) with attributed
    device-time, token throughput, FLOP rate, and unit cost — the
    who-is-spending-the-accelerator surface."""
    if not rows:
        return []
    rated = any(r.get("device_ms_per_s") is not None for r in rows.values())
    lines = ["", f"  {'MODEL/TENANT':<24}"
                 + (f"{'DEVms/s':>9}" if rated else f"{'DEVms':>9}")
                 + (f"{'TOK/s':>8}" if rated else f"{'TOKENS':>8}")
                 + (f"{'GFLOP/s':>9}" if rated else "")
                 + f"{'us/TOK':>10}{'KV GB*s':>9}"]
    for (model, tenant), r in sorted(rows.items()):
        label = f"{model}/{tenant or '-'}"
        dev = (r["device_ms_per_s"] if rated
               else round(r["device_us"] / 1e3, 1))
        tok = r["tokens_per_s"] if rated else r["tokens"]
        line = f"  {label:<24}{_fmt(dev, 2):>9}{_fmt(tok):>8}"
        if rated:
            line += f"{_fmt(r['gflops_per_s']):>9}"
        line += (f"{_fmt(r['us_per_token']):>10}"
                 f"{_fmt(r['kv_byte_seconds'] / 1e9, 3):>9}")
        lines.append(line)
    return lines


def aggregate_restarts(per_url: Dict[str, Dict[str, float]]) -> int:
    """Fleet worker-restart total across polled endpoints.  Every
    worker of one supervised fleet reports the SAME fleet-global
    counters (they all read the supervisor's shared state file), so a
    per-endpoint SUM would multiply the truth by the number of polled
    workers — dedup by taking the max per worker label across
    endpoints, then sum workers."""
    per_worker: Dict[str, float] = {}
    for counts in per_url.values():
        for worker, v in (counts or {}).items():
            per_worker[worker] = max(per_worker.get(worker, 0.0), v)
    return int(sum(per_worker.values()))


def _outlier_brief(o: Optional[dict]) -> Optional[Dict[str, Any]]:
    if o is None:
        return None
    # age_s is computed by the SERVER at snapshot time (its clock) —
    # differencing o["ts"] against this host's clock would be wrong under
    # skew; fall back to it only for pre-age_s servers
    age = o.get("age_s")
    if age is None:
        age = round(max(0.0, time.time() - o["ts"]), 1)
    return {
        "seq": o["seq"],
        "age_s": age,
        "total_ms": round(o["total_us"] / 1e3, 2),
        "reason": o.get("capture_reason"),
        "outcome": o.get("outcome"),
        "chaos": o.get("chaos"),
        "request_id": o.get("request_id", ""),
    }


def aggregate_rows(per_url_rows: Dict[str, Dict[str, Dict[str, Any]]]
                   ) -> Dict[str, Dict[str, Any]]:
    """Fold per-server model rows into one fleet row per model.

    Additive columns (QPS, pending, shed/deadline rates, watchdog counts)
    sum; latency/queue/batch/error columns take the WORST replica — an
    operator triaging a fleet needs the tail that users actually see, and
    averaging replicas hides exactly the straggler they're looking for.
    The newest outlier across replicas (smallest server-computed age)
    represents the fleet.
    """
    models: set = set()
    for rows in per_url_rows.values():
        models.update(rows)
    agg: Dict[str, Dict[str, Any]] = {}
    for model in sorted(models):
        rows = [r[model] for r in per_url_rows.values() if model in r]

        def _sum(key, nd=1):
            vals = [r[key] for r in rows if r.get(key) is not None]
            return round(sum(vals), nd) if vals else None

        def _worst(key):
            vals = [r[key] for r in rows if r.get(key) is not None]
            return max(vals) if vals else None

        outliers = [r["last_outlier"] for r in rows
                    if r.get("last_outlier") is not None]
        agg[model] = {
            "qps": _sum("qps"),
            "p50_ms": _worst("p50_ms"),
            "p99_ms": _worst("p99_ms"),
            "queue_share_pct": _worst("queue_share_pct"),
            "batch_avg": _worst("batch_avg"),
            "pending": sum(r["pending"] for r in rows),
            "error_pct": _worst("error_pct"),
            "rejected_per_s": _sum("rejected_per_s"),
            "deadline_exceeded_per_s": _sum("deadline_exceeded_per_s"),
            "slow_total": sum(r["slow_total"] for r in rows),
            "captured_total": sum(r["captured_total"] for r in rows),
            "threshold_ms": _worst("threshold_ms"),
            # device/SLO columns: worst replica (the fleet pages on its
            # hottest/most-burning member, not the average)
            "duty_pct": _worst("duty_pct"),
            "mfu_pct": _worst("mfu_pct"),
            # memory governor: MEM% = worst replica (the one nearest its
            # budget pages first), shed rate sums like the other sheds
            "mem_pct": _worst("mem_pct"),
            "mem_shed_per_s": _sum("mem_shed_per_s"),
            # host columns: LAG takes the worst replica (the stall users
            # on that replica actually feel); the GC rate sums like the
            # other per-process rates
            "host_lag_ms": _worst("host_lag_ms"),
            "gc_ms_per_s": _sum("gc_ms_per_s", nd=2),
            "burn_5m": _worst("burn_5m"),
            "burn_1h": _worst("burn_1h"),
            "slo_breach": any(r.get("slo_breach") for r in rows),
            # fleet columns: instances sum (total executing capacity),
            # version = the newest any replica serves (a mid-rollout
            # fleet shows the front of the wave; the per-server rows
            # underneath show who lags), marker if ANY replica actuated
            "instances": _sum("instances", nd=0),
            "version": _worst("version"),
            "scaled": "".join(sorted({c for r in rows
                                      for c in (r.get("scaled") or "")}),
                              ) or None,
            # device faults sum across replicas; QUAR flags when ANY
            # replica is refusing traffic (the one the client routes
            # around — exactly what the operator should see)
            "fault_per_s": _sum("fault_per_s"),
            "quarantined": any(r.get("quarantined") for r in rows),
            # prefix-cache columns: HIT% recomputed from the SUMMED raw
            # hit/lookup deltas (averaging per-replica percentages would
            # let an idle replica's dash/100% skew the fleet ratio);
            # CACHE-MB sums — each replica pins its own device bytes
            "cache_hits_d": _sum("cache_hits_d"),
            "cache_lookups_d": _sum("cache_lookups_d"),
            "hit_pct": _fleet_hit_pct(rows),
            "cache_mb": _sum("cache_mb"),
            "last_outlier": (min(outliers, key=lambda o: o["age_s"])
                            if outliers else None),
        }
    return agg


def _fleet_hit_pct(rows) -> Optional[float]:
    hits = sum(r.get("cache_hits_d") or 0.0 for r in rows)
    lookups = sum(r.get("cache_lookups_d") or 0.0 for r in rows)
    if lookups <= 0:
        return None
    return round(100.0 * hits / lookups, 1)


# -- rendering ---------------------------------------------------------------

def _fmt(v, nd: int = 1) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v)


_COLUMNS = (f"  {'MODEL':<24}{'QPS':>8}{'P50ms':>9}{'P99ms':>9}{'QUEUE%':>8}"
            f"{'BATCH':>7}{'PEND':>6}{'ERR%':>7}{'REJ/s':>7}{'DLX/s':>7}"
            f"{'SLOW':>6}{'CAPT':>6}{'DUTY%':>7}{'MEM%':>7}{'SHED/s':>8}"
            f"{'INST':>6}{'VER':>5}"
            f"{'LAGms':>8}{'GCms/s':>8}"
            f"{'FAULT':>7}{'QUAR':>6}"
            f"{'HIT%':>7}{'CACHE-MB':>10}"
            f"{'BURN':>9}"
            f"  LAST OUTLIER")


def _row_line(label: str, r: Dict[str, Any]) -> str:
    o = r["last_outlier"]
    brief = ""
    if o is not None:
        brief = (f"{o['age_s']:g}s ago {o['total_ms']:g}ms "
                 f"{o['reason'] or ''}")
        if o.get("chaos"):
            # injected weather, labeled so an operator staring at a
            # spike can tell the chaos harness from the real world
            brief += f" [chaos:{o['chaos']}]"
        if o["outcome"] != "ok":
            brief += f" ({o['outcome'][:40]})"
    # the breach marker rides the burn column: "23.1!" = both windows
    # over the fast-burn threshold (the page condition); the autoscale
    # marker rides next to it — "^" = scaled out since the last poll,
    # "v" = scaled in (the alarm and its actuator, side by side)
    burn = _fmt(r.get("burn_5m"))
    if r.get("slo_breach"):
        burn += "!"
    if r.get("scaled"):
        burn += r["scaled"]
    return (
        f"  {label:<24}{_fmt(r['qps']):>8}{_fmt(r['p50_ms']):>9}"
        f"{_fmt(r['p99_ms']):>9}{_fmt(r['queue_share_pct']):>8}"
        f"{_fmt(r['batch_avg']):>7}{r['pending']:>6}"
        f"{_fmt(r['error_pct'], 2):>7}{_fmt(r['rejected_per_s']):>7}"
        f"{_fmt(r['deadline_exceeded_per_s']):>7}{r['slow_total']:>6}"
        f"{r['captured_total']:>6}{_fmt(r.get('duty_pct')):>7}"
        f"{_fmt(r.get('mem_pct')):>7}{_fmt(r.get('mem_shed_per_s')):>8}"
        f"{_fmt(r.get('instances')):>6}{_fmt(r.get('version')):>5}"
        f"{_fmt(r.get('host_lag_ms'), 2):>8}"
        f"{_fmt(r.get('gc_ms_per_s'), 2):>8}"
        f"{_fmt(r.get('fault_per_s')):>7}"
        f"{('QUAR' if r.get('quarantined') else '-'):>6}"
        f"{_fmt(r.get('hit_pct')):>7}{_fmt(r.get('cache_mb')):>10}"
        f"{burn:>9}  {brief}")


def _bucket_rank(bucket: Any) -> tuple:
    """Numeric-first sort key for bucket labels (Prometheus hands them
    back as strings: "8" must come before "16", not after "128")."""
    try:
        return (0, int(bucket))
    except (TypeError, ValueError):
        return (1, str(bucket))


def _bucket_lines(rows: Dict[tuple, Dict[str, Any]]) -> List[str]:
    """The buckets view: one line per (model, bucket) with tick rate,
    realized occupancy, pad waste, assembly cost, and queue depth — the
    read-the-dashboard surface for bucket-geometry tuning."""
    if not rows:
        return []
    rated = any(r.get("ticks_per_s") is not None for r in rows.values())
    tick_hdr = "TICK/s" if rated else "TICKS"
    lines = ["", f"  {'MODEL/BUCKET':<24}{tick_hdr:>8}{'AVGBATCH':>10}"
                 f"{'PAD%':>7}{'ASM us':>9}{'QDEPTH':>8}{'SYNC/T':>8}"
                 f"{'STEP/T':>8}{'UPL/T':>8}{'AI':>8}  ROOFLINE"]
    for (model, bucket), r in sorted(
            rows.items(), key=lambda kv: (kv[0][0], _bucket_rank(kv[0][1]))):
        ticks = r["ticks_per_s"] if rated else r.get("ticks")
        # roofline verdict + achieved %-of-peak, e.g. "mem 38%": which
        # wall this bucket leans on and how hard it pushes it — "-" when
        # the server has no cost analysis, never a fabricated value
        verdict = r.get("roofline_verdict")
        if verdict:
            roof = "comp" if verdict == "compute_bound" else "mem"
            if r.get("roofline_pct") is not None:
                roof += f" {r['roofline_pct']:.0f}%"
        else:
            roof = "-"
        lines.append(
            f"  {model + '@' + str(bucket):<24}{_fmt(ticks):>8}"
            f"{_fmt(r['avg_batch']):>10}{_fmt(r['pad_pct']):>7}"
            f"{_fmt(r['avg_assembly_us']):>9}{_fmt(r['avg_queue_depth']):>8}"
            f"{_fmt(r['syncs_per_tick'], 2):>8}"
            f"{_fmt(r.get('steps_per_tick'), 2):>8}"
            f"{_fmt(r.get('uploads_per_tick'), 2):>8}"
            f"{_fmt(r.get('roofline_ai')):>8}  {roof}")
    return lines


def render(url: str, cur: Dict[str, Any],
           rows: Dict[str, Dict[str, Any]], interval: float,
           tenants: Optional[Dict[str, Dict[str, Any]]] = None,
           buckets: Optional[Dict[tuple, Dict[str, Any]]] = None,
           costs: Optional[Dict[tuple, Dict[str, Any]]] = None) -> str:
    recorder = cur["recorder"]
    restarts = int(sum(
        ((cur.get("device") or {}).get("restarts") or {}).values()))
    lines = [
        f"triton-top — {url} — {time.strftime('%H:%M:%S')}  "
        f"refresh={interval:g}s  recorder="
        f"{'on' if recorder.get('enabled') else 'OFF'} "
        f"({recorder.get('capture_slower_than')}, "
        f"{recorder.get('recorded_total', 0)} recorded, "
        f"{len(recorder.get('outliers', []))} outlier(s) pinned)"
        # the self-healing supervisor's scoreboard: nonzero means a
        # frontend worker crashed and was restarted behind this port
        + (f"  worker-restarts={restarts}" if restarts else ""),
        "",
        _COLUMNS,
    ]
    for model, r in rows.items():
        lines.append(_row_line(model, r))
    if not rows:
        lines.append("  (no recorded requests yet)")
    lines.extend(_bucket_lines(buckets or {}))
    lines.extend(_cost_lines(costs or {}))
    lines.extend(_tenant_lines(tenants or {}))
    return "\n".join(lines) + "\n"


def render_fleet(urls: List[str],
                 per_url_rows: Dict[str, Dict[str, Dict[str, Any]]],
                 agg: Dict[str, Dict[str, Any]], interval: float,
                 tenants: Optional[Dict[str, Dict[str, Any]]] = None,
                 buckets: Optional[Dict[tuple, Dict[str, Any]]] = None,
                 costs: Optional[Dict[tuple, Dict[str, Any]]] = None,
                 restarts: int = 0) -> str:
    """Fleet view: one aggregated row per model (sums + worst-replica
    tails) with a per-server breakdown row for every polled endpoint."""
    down = [u for u in urls if u not in per_url_rows]
    header = (f"triton-top — fleet of {len(urls)} "
              f"({len(urls) - len(down)} up) — {time.strftime('%H:%M:%S')}  "
              f"refresh={interval:g}s")
    if restarts:
        header += f"  worker-restarts={restarts}"
    if down:
        header += "  DOWN: " + ", ".join(down)
    lines = [header, "", _COLUMNS]
    for model, row in agg.items():
        lines.append(_row_line(model, row))
        for u in urls:
            rows = per_url_rows.get(u)
            if rows is not None and model in rows:
                lines.append(_row_line(f" └ {u}", rows[model]))
    if not agg:
        lines.append("  (no recorded requests yet)")
    lines.extend(_bucket_lines(buckets or {}))
    lines.extend(_cost_lines(costs or {}))
    lines.extend(_tenant_lines(tenants or {}))
    return "\n".join(lines) + "\n"


def _buckets_json(rows: Dict[tuple, Dict[str, Any]]) -> Dict[str, Any]:
    """Tuple-keyed bucket rows -> ``{model: {bucket: row}}`` for JSON."""
    out: Dict[str, Any] = {}
    for (model, bucket), r in sorted(
            rows.items(), key=lambda kv: (kv[0][0], _bucket_rank(kv[0][1]))):
        out.setdefault(model, {})[str(bucket)] = r
    return out


def _costs_json(rows: Dict[tuple, Dict[str, Any]]) -> Dict[str, Any]:
    """Tuple-keyed cost rows -> ``{model: {tenant: row}}`` for JSON."""
    out: Dict[str, Any] = {}
    for (model, tenant), r in sorted(rows.items()):
        out.setdefault(model, {})[tenant] = r
    return out


# -- CLI --------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="triton-top",
        description="Live per-model console for a running server: polls "
                    "/metrics and /v2/debug/flight_recorder, renders QPS, "
                    "p50/p99, queue share, batch occupancy, error rate, "
                    "and the most recent tail-latency outlier.")
    parser.add_argument("--url", action="append", default=None,
                        help="server host:port (default localhost:8000); "
                             "repeat for a fleet — every server is polled "
                             "and the table aggregates per model with a "
                             "per-server breakdown row")
    parser.add_argument("--interval", type=float, default=2.0,
                        help="refresh interval in seconds (default 2.0)")
    parser.add_argument("--once", action="store_true",
                        help="take one snapshot and exit (rate columns "
                             "fall back to cumulative counters)")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit machine-readable JSON instead of the "
                             "table (for scripting; pairs with --once)")
    parser.add_argument("--all", action="store_true", dest="include_idle",
                        help="show every registered model, including ones "
                             "that have never served a request")
    parser.add_argument("--limit", type=int, default=None,
                        help="recent-ring entries fetched per poll "
                             "(default: 0 = whole ring with --once, 1 in "
                             "live mode — the table reads only the "
                             "per-model stats and outliers, so pulling a "
                             "large ring every refresh would be waste)")
    parser.add_argument("--timeout", type=float, default=5.0,
                        help="per-poll HTTP timeout in seconds")
    args = parser.parse_args(argv)

    bases = []
    for u in (args.url or ["localhost:8000"]):
        base = u if "://" in u else f"http://{u}"
        bases.append(base.rstrip("/"))
    fleet = len(bases) > 1
    limit = args.limit if args.limit is not None else (0 if args.once else 1)

    def sample_all(quiet=False):
        """One poll of every server, in parallel — a blackholed replica
        must cost the fleet one --timeout, not one per dead replica per
        refresh.  An unreachable server maps to None — the fleet view
        must survive (and show) a dead replica."""
        # pre-filled: a poll thread that outlives its join timeout must
        # leave its server marked down, not missing from the dict
        out = {base: None for base in bases}
        lock = threading.Lock()

        def poll_one(base):
            try:
                s = sample(base, args.timeout, limit=limit)
            except (urllib.error.URLError, OSError, ValueError) as e:
                s = None
                if not quiet:
                    print(f"error: cannot poll {base}: {e}",
                          file=sys.stderr)
            with lock:
                out[base] = s

        if len(bases) == 1:
            poll_one(bases[0])
            return out
        threads = [threading.Thread(target=poll_one, args=(b,),
                                    daemon=True) for b in bases]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=args.timeout + 5.0)
        return out

    def fold(cur, prev):
        """Per-server rows + the fleet aggregates from one (or two)
        polls; also returns the per-tenant QoS aggregate, the
        (model, bucket) tick aggregate, and the summed supervisor
        worker-restart count."""
        per_url = {}
        per_url_tenants = {}
        per_url_buckets = {}
        per_url_costs = {}
        per_url_restarts = {}
        for base, s in cur.items():
            if s is None:
                continue
            p = prev.get(base) if prev else None
            per_url[base] = model_rows(s, p,
                                       include_idle=args.include_idle)
            per_url_tenants[base] = tenant_rows(s, p)
            per_url_buckets[base] = bucket_rows(s, p)
            per_url_costs[base] = cost_rows(s, p)
            per_url_restarts[base] = (s.get("device") or {}).get(
                "restarts") or {}
        return (per_url, aggregate_rows(per_url),
                aggregate_tenants(per_url_tenants),
                aggregate_buckets(per_url_buckets),
                aggregate_costs(per_url_costs),
                aggregate_restarts(per_url_restarts))

    cur = sample_all()
    if all(s is None for s in cur.values()):
        return 1
    if args.once:
        per_url, agg, tenants, buckets, costs, restarts = fold(cur, None)
        if args.as_json:
            if fleet:
                out = {
                    "urls": bases,
                    "ts": time.time(),
                    "models": agg,
                    "tenants": tenants,
                    "buckets": _buckets_json(buckets),
                    "costs": _costs_json(costs),
                    "worker_restarts": restarts,
                    # per-endpoint samples: each server's rows + recorder
                    "endpoints": {
                        base: (None if cur[base] is None else {
                            "models": per_url.get(base, {}),
                            "recorder": cur[base]["recorder"],
                        }) for base in bases
                    },
                }
            else:
                # single-url shape unchanged (scripting compat); buckets
                # and worker_restarts are additive — new keys, never a
                # reshaped one
                out = {
                    "url": bases[0],
                    "ts": time.time(),
                    "models": per_url.get(bases[0], {}),
                    "tenants": tenants,
                    "buckets": _buckets_json(buckets),
                    "costs": _costs_json(costs),
                    "worker_restarts": restarts,
                    "recorder": cur[bases[0]]["recorder"],
                }
            print(json.dumps(out, indent=2))
        elif fleet:
            sys.stdout.write(render_fleet(bases, per_url, agg,
                                          args.interval, tenants=tenants,
                                          buckets=buckets, costs=costs,
                                          restarts=restarts))
        else:
            sys.stdout.write(render(bases[0], cur[bases[0]],
                                    per_url.get(bases[0], {}),
                                    args.interval, tenants=tenants,
                                    buckets=buckets, costs=costs))
        return 0

    prev = cur
    try:
        while True:
            time.sleep(max(0.05, args.interval))
            cur = sample_all(quiet=True)
            if all(s is None for s in cur.values()):
                # transient blip (deploy, overloaded scrape): keep the
                # console alive and retry — monitoring must not die at
                # exactly the moment the server gets interesting
                continue
            per_url, agg, tenants, buckets, costs, restarts = fold(cur, prev)
            if args.as_json:
                print(json.dumps({
                    "ts": time.time(),
                    "models": agg if fleet else
                              next(iter(per_url.values()), {}),
                    "tenants": tenants,
                    "buckets": _buckets_json(buckets),
                    "costs": _costs_json(costs),
                    "worker_restarts": restarts,
                    **({"endpoints": {b: per_url.get(b)
                                      for b in bases}} if fleet else {}),
                }))
            else:
                # clear screen + home, top(1)-style
                sys.stdout.write("\x1b[H\x1b[2J")
                if fleet:
                    sys.stdout.write(render_fleet(bases, per_url, agg,
                                                  args.interval,
                                                  tenants=tenants,
                                                  buckets=buckets,
                                                  costs=costs,
                                                  restarts=restarts))
                else:
                    sys.stdout.write(render(bases[0], cur[bases[0]],
                                            per_url.get(bases[0], {}),
                                            args.interval,
                                            tenants=tenants,
                                            buckets=buckets,
                                            costs=costs))
                sys.stdout.flush()
            # a server that missed THIS poll keeps its previous sample as
            # the delta base, so its next successful poll shows a sane rate
            prev = {b: (cur[b] if cur[b] is not None else prev.get(b))
                    for b in bases}
    except KeyboardInterrupt:
        return 0
    except BrokenPipeError:
        # downstream consumer closed (e.g. `triton-top --json | head`)
        return 0


if __name__ == "__main__":
    sys.exit(main())
