"""The trace-file summary ``perf_analyzer --trace-file`` prints.

The port's trimmed copy of ``triton_client_tpu/tools/trace_summary.py``:
:func:`load_trace_file`, :func:`summarize` and :func:`format_text` over
the server's JSON-Lines records (one per traced request, span-structured,
or the legacy flat timestamps), without the client join, the journeys and
the Chrome export.  The tool itself, as a CLI, is not ported yet (ROADMAP
A6b).
"""

from __future__ import annotations

import json
import math
from typing import Any, Dict, List, Sequence, Tuple

#: Server-side stages in reporting order.
SERVER_STAGES = (
    "DECODE",
    "QUEUE",
    "SLOT_WAIT",
    "PREFILL",
    "BATCH_ASSEMBLY",
    "H2D_TRANSFER",
    "COMPUTE",
    "D2H_TRANSFER",
    "SERIALIZE",
    "NETWORK_WRITE",
)
#: Client-side stages recorded by the instrumented clients.

def load_trace_file(path: str) -> List[dict]:
    """Parse a JSON-Lines trace file; blank lines are skipped, a malformed
    line fails loudly with its line number (a silently-dropped record would
    skew every percentile below)."""
    records = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError as e:
                raise ValueError(f"{path}:{lineno}: not valid JSON: {e}")
            if not isinstance(rec, dict):
                raise ValueError(f"{path}:{lineno}: trace record must be an "
                                 "object")
            records.append(rec)
    return records


def record_spans(rec: dict) -> List[Tuple[str, int, int]]:
    """(name, start_ns, end_ns) intervals of one record.  Span-structured
    records are used as-is; legacy records derive REQUEST and COMPUTE from
    their ``*_START``/``*_END`` timestamp pairs and QUEUE from
    QUEUE_START→COMPUTE_START (the legacy shape never wrote a QUEUE_END)."""
    spans = rec.get("spans")
    if spans:
        return [(s["name"], int(s["start_ns"]), int(s["end_ns"]))
                for s in spans]
    ts: Dict[str, int] = {}
    for t in rec.get("timestamps", []):
        ts.setdefault(str(t["name"]), int(t["ns"]))
    out: List[Tuple[str, int, int]] = []
    for name in {n[: -len("_START")] for n in ts if n.endswith("_START")}:
        start = ts.get(name + "_START")
        end = ts.get(name + "_END")
        if end is None and name == "QUEUE":
            end = ts.get("COMPUTE_START")
        if start is not None and end is not None:
            out.append((name, start, end))
    out.sort(key=lambda s: (s[1], s[0]))
    return out


def token_events(rec: dict) -> List[Tuple[int, int]]:
    """(token index, ns) pairs of a stream record's strided token
    timeline: ``FIRST_TOKEN`` is index 0, ``TOKEN[n]`` is index n.  Sorted
    by index; empty for unary records."""
    out: List[Tuple[int, int]] = []
    for t in rec.get("timestamps", []):
        name = str(t.get("name", ""))
        if name == "FIRST_TOKEN":
            out.append((0, int(t["ns"])))
        elif name.startswith("TOKEN[") and name.endswith("]"):
            try:
                out.append((int(name[len("TOKEN["):-1]), int(t["ns"])))
            except ValueError:
                continue
    out.sort()
    return out


def percentile(sorted_vals: Sequence[float], p: float) -> float:
    """Nearest-rank percentile over an already-sorted sequence."""
    if not sorted_vals:
        return float("nan")
    rank = max(1, math.ceil(p / 100.0 * len(sorted_vals)))
    return sorted_vals[min(rank, len(sorted_vals)) - 1]


def _stage_stats(durations_ns: List[int]) -> Dict[str, Any]:
    vals = sorted(durations_ns)
    n = len(vals)
    if not n:
        # None, not NaN: summaries embed into strict-JSON exports
        # (perf_analyzer --export-metrics, bench.py)
        return {"count": 0, "mean_us": None, "p50_us": None,
                "p90_us": None, "p99_us": None}
    return {
        "count": n,
        "mean_us": (sum(vals) / n) / 1e3,
        "p50_us": percentile(vals, 50) / 1e3,
        "p90_us": percentile(vals, 90) / 1e3,
        "p99_us": percentile(vals, 99) / 1e3,
    }


def summarize(server_records: List[dict]) -> Dict[str, Any]:
    """Aggregate server trace records: per-model stage stats, queue share,
    generation timelines, the buckets view and the cost stamps."""
    models: Dict[str, Dict[str, Any]] = {}
    per_model_stage: Dict[str, Dict[str, List[int]]] = {}
    per_model_request: Dict[str, List[int]] = {}
    # per-model generation timeline stats (stream records: "tokens" +
    # FIRST_TOKEN / strided TOKEN[n] events) — TTFT is first token vs the
    # REQUEST root, ITL is recovered from the strided gaps as
    # (t[n+k]-t[n])/k so any stride yields per-token estimates
    per_model_gen: Dict[str, Dict[str, Any]] = {}
    # (model, bucket) -> accumulated tick fields (records that rode the
    # dynamic batcher carry a "tick" object: bucket chosen, occupancy,
    # pad waste, queue depth, assembly cost)
    per_bucket: Dict[Tuple[str, int], Dict[str, Any]] = {}
    # model -> tenant -> accumulated cost stamps (records attributed by
    # the cost ledger carry a "cost" object: tenant, device_us, tokens)
    per_model_cost: Dict[str, Dict[str, Dict[str, Any]]] = {}
    for rec in server_records:
        model = str(rec.get("model_name", "?"))
        stages = per_model_stage.setdefault(model, {})
        root_start = None
        for name, start, end in record_spans(rec):
            dur = max(0, end - start)
            if name == "REQUEST":
                per_model_request.setdefault(model, []).append(dur)
                root_start = start
            else:
                stages.setdefault(name, []).append(dur)
        if "tokens" in rec:
            g = per_model_gen.setdefault(model, {
                "streams": 0, "tokens": 0, "failed": 0, "cancelled": 0,
                "ttft": [], "itl": []})
            g["streams"] += 1
            g["tokens"] += int(rec.get("tokens") or 0)
            outcome = str(rec.get("outcome", "ok"))
            if outcome == "cancelled":
                # consumer walked away mid-stream — served, not failed
                g["cancelled"] += 1
            elif outcome != "ok":
                g["failed"] += 1
            evs = token_events(rec)
            if evs and root_start is not None:
                g["ttft"].append(max(0, evs[0][1] - root_start))
            for (n0, t0), (n1, t1) in zip(evs, evs[1:]):
                if n1 > n0:
                    g["itl"].append(max(0, (t1 - t0) // (n1 - n0)))
        cost = rec.get("cost")
        if isinstance(cost, dict):
            c = per_model_cost.setdefault(model, {}).setdefault(
                str(cost.get("tenant", "")),
                {"records": 0, "device_us": 0.0, "tokens": 0})
            c["records"] += 1
            c["device_us"] += float(cost.get("device_us") or 0.0)
            c["tokens"] += int(cost.get("tokens") or 0)
        tick = rec.get("tick")
        if isinstance(tick, dict) and "bucket" in tick:
            agg = per_bucket.setdefault((model, int(tick["bucket"])), {
                "records": 0, "batch": [], "pad": [], "depth": [],
                "assembly_us": []})
            agg["records"] += 1
            for field, key in (("batch", "batch"), ("pad", "pad_fraction"),
                               ("depth", "queue_depth"),
                               ("assembly_us", "assembly_us")):
                if key in tick:
                    agg[field].append(float(tick[key]))
    for model, stages in per_model_stage.items():
        requests = per_model_request.get(model, [])
        total_request_ns = sum(requests)
        stage_out: Dict[str, Any] = {}
        order = [s for s in SERVER_STAGES if s in stages] + sorted(
            s for s in stages if s not in SERVER_STAGES)
        for name in order:
            st = _stage_stats(stages[name])
            st["share_pct"] = (100.0 * sum(stages[name]) / total_request_ns
                               if total_request_ns else None)
            stage_out[name] = st
        entry: Dict[str, Any] = {
            "count": len(requests) or max(
                (len(v) for v in stages.values()), default=0),
            "request": _stage_stats(requests),
            "stages": stage_out,
        }
        if "QUEUE" in stage_out:
            entry["queue_share_pct"] = stage_out["QUEUE"]["share_pct"]
        models[model] = entry
    for model, g in per_model_gen.items():
        entry = models.setdefault(model, {"count": 0, "request":
                                          _stage_stats([]), "stages": {}})
        entry["generation"] = {
            "streams": g["streams"],
            "tokens": g["tokens"],
            "failed": g["failed"],
            "cancelled": g["cancelled"],
            "ttft_us": _stage_stats(g["ttft"]),
            "itl_us": _stage_stats(g["itl"]),
        }
    for (model, bucket), agg in sorted(per_bucket.items()):
        entry = models.setdefault(model, {"count": 0, "request":
                                          _stage_stats([]), "stages": {}})
        n = agg["records"]

        def _avg(vals):
            return round(sum(vals) / len(vals), 2) if vals else None

        entry.setdefault("buckets", {})[str(bucket)] = {
            "records": n,
            "avg_batch": _avg(agg["batch"]),
            "pad_waste_pct": (round(100.0 * sum(agg["pad"]) / len(agg["pad"]),
                                    1) if agg["pad"] else None),
            "avg_queue_depth": _avg(agg["depth"]),
            "avg_assembly_us": _avg(agg["assembly_us"]),
        }
    for model, tenants in sorted(per_model_cost.items()):
        entry = models.setdefault(model, {"count": 0, "request":
                                          _stage_stats([]), "stages": {}})
        # per-tenant attributed device-time over the SAMPLED records only
        # (the cost ledger's /v2/debug/costs is the complete total; this
        # table shows what the traced subset spent)
        entry["costs"] = {
            t: {"records": c["records"],
                "device_us": round(c["device_us"], 1),
                "tokens": c["tokens"],
                "us_per_token": (round(c["device_us"] / c["tokens"], 1)
                                 if c["tokens"] else None)}
            for t, c in sorted(tenants.items())}
    summary: Dict[str, Any] = {
        "requests": len(server_records),
        "models": {m: models[m] for m in sorted(models)},
    }
    return summary



def _fmt_val(v) -> str:
    return "-" if v is None or v != v else f"{v:.1f}"  # None/NaN-safe


def _stage_table(rows: List[Tuple[str, Dict[str, float]]],
                 share: bool) -> List[str]:
    head = (f"  {'stage':<16}{'count':>7}{'mean_us':>12}{'p50_us':>12}"
            f"{'p90_us':>12}{'p99_us':>12}")
    if share:
        head += f"{'share%':>9}"
    lines = [head]
    for name, st in rows:
        line = (f"  {name:<16}{st['count']:>7}{_fmt_val(st['mean_us']):>12}"
                f"{_fmt_val(st['p50_us']):>12}{_fmt_val(st['p90_us']):>12}"
                f"{_fmt_val(st['p99_us']):>12}")
        if share:
            line += f"{_fmt_val(st.get('share_pct', float('nan'))):>9}"
        lines.append(line)
    return lines


def format_text(summary: Dict[str, Any]) -> str:
    lines: List[str] = []
    n_models = len(summary["models"])
    lines.append(f"== server trace: {summary['requests']} request(s), "
                 f"{n_models} model(s) ==")
    for model, entry in summary["models"].items():
        lines.append("")
        lines.append(f"model={model}  requests={entry['count']}")
        req = entry["request"]
        lines.append(
            f"  {'REQUEST':<16}{req['count']:>7}"
            f"{_fmt_val(req['mean_us']):>12}{_fmt_val(req['p50_us']):>12}"
            f"{_fmt_val(req['p90_us']):>12}{_fmt_val(req['p99_us']):>12}")
        lines.extend(_stage_table(list(entry["stages"].items()), share=True))
        if "queue_share_pct" in entry:
            lines.append(
                f"  queue share: "
                f"{_fmt_val(entry['queue_share_pct'])}% of request time")
        gen = entry.get("generation")
        if gen:
            ttft, itl = gen["ttft_us"], gen["itl_us"]
            lines.append(
                f"  generation: streams={gen['streams']} "
                f"tokens={gen['tokens']} failed={gen['failed']} "
                f"cancelled={gen['cancelled']}")
            lines.append(
                f"    TTFT us: p50 {_fmt_val(ttft['p50_us'])}  "
                f"p99 {_fmt_val(ttft['p99_us'])}   "
                f"ITL us: p50 {_fmt_val(itl['p50_us'])}  "
                f"p99 {_fmt_val(itl['p99_us'])}")
        buckets = entry.get("buckets")
        if buckets:
            # the buckets view: which tick shapes the sampled requests
            # rode, at what occupancy/pad waste — bucket-geometry tuning
            # reads straight off this table
            lines.append(f"  {'bucket':<10}{'records':>9}{'avg_batch':>11}"
                         f"{'pad%':>7}{'qdepth':>8}{'asm_us':>9}")
            for bucket, b in sorted(buckets.items(), key=lambda kv:
                                    int(kv[0])):
                lines.append(
                    f"  {bucket:<10}{b['records']:>9}"
                    f"{_fmt_val(b['avg_batch']):>11}"
                    f"{_fmt_val(b['pad_waste_pct']):>7}"
                    f"{_fmt_val(b['avg_queue_depth']):>8}"
                    f"{_fmt_val(b['avg_assembly_us']):>9}")
        costs = entry.get("costs")
        if costs:
            # who spent the device time among the traced requests — the
            # sampled-view companion to /v2/debug/costs
            lines.append(f"  {'tenant':<16}{'records':>9}{'device_us':>12}"
                         f"{'tokens':>8}{'us/tok':>8}")
            for tenant, c in costs.items():
                lines.append(
                    f"  {tenant or '-':<16}{c['records']:>9}"
                    f"{_fmt_val(c['device_us']):>12}{c['tokens']:>8}"
                    f"{_fmt_val(c['us_per_token']):>8}")
    return "\n".join(lines) + "\n"
