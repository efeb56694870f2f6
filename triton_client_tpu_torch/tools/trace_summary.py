"""The trace-file analyzer: summaries, the client join, journeys and a
Chrome export of the server's trace files.

The port's counterpart of ``triton_client_tpu/tools/trace_summary.py``,
function for function and line for line in what it prints, so a trace
read by either tool reads the same::

    python -m triton_client_tpu_torch.tools.trace_summary server.json
    python -m triton_client_tpu_torch.tools.trace_summary 'replica-*.json' \
        --client client.json            # join on triton-request-id
    python -m triton_client_tpu_torch.tools.trace_summary server.json \
        --format chrome -o trace.chrome.json   # load in Perfetto / chrome://tracing

The port has no console script for it.  Inputs are JSON Lines:

* **server file** -- one object per traced request, written by the
  server's ``RequestTracer`` (``server/trace.py``; ``trace_level=
  TIMESTAMPS`` through ``/v2/trace/setting``).  Span-structured records
  carry ``"spans": [{"name", "start_ns", "end_ns", "parent"}, ...]`` with
  a ``REQUEST`` root; legacy records carry only ``"timestamps"`` and get
  REQUEST/QUEUE/COMPUTE derived from the pairs.
* **client file** -- one object per inference, written by
  ``telemetry().enable_tracing(path)`` (``_telemetry``) in the port's
  clients: ``{"request_id", "model", "protocol", "traceparent", "spans":
  [REQUEST, SERIALIZE, NETWORK, DESERIALIZE, ...]}``.

The two files join on the propagated ``triton-request-id`` (the server
record's ``triton_request_id`` key), and the journeys on the trace id of
``traceparent``.  The clocks are different processes' monotonic clocks,
so the join compares **durations** only: network overhead = client
REQUEST duration - server REQUEST duration.

A stage that no record carries has no row: the port's server writes no
H2D_TRANSFER span (it maps a shared-memory region with cudaIPC and copies
nothing), so a summary of its traces has no H2D_TRANSFER entry at all,
never one counted 0.

Standard library only: the tool runs (and ``--help`` exits 0) wherever a
trace file was copied to, without PyTorch or numpy.
"""

from __future__ import annotations

import argparse
import glob as _glob
import json
import math
import os
import re
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: Server-side stages in reporting order (the span names of both
#: packages' ``server/trace.py``; the port's server writes all of them but
#: H2D_TRANSFER).
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
CLIENT_STAGES = ("SERIALIZE", "NETWORK", "DESERIALIZE")


def expand_inputs(paths: Sequence[str]) -> List[str]:
    """Expand a mix of literal paths, globs, and directories into a
    deduplicated file list.  A directory contributes every regular file in
    it (one rotated trace set per directory is the common layout); a glob
    contributes its matches.  Dedup is by ``realpath`` so overlapping
    specs — ``trace.json trace.json*``, or a directory plus a glob into
    it — never double-count a rotated file's records.  A literal path
    with no glob match is kept as-is so ``open()`` fails loudly."""
    out: List[str] = []
    seen = set()
    for p in paths:
        if os.path.isdir(p):
            matches = sorted(
                m for m in _glob.glob(os.path.join(p, "*"))
                if os.path.isfile(m))
        else:
            matches = sorted(m for m in _glob.glob(p) if os.path.isfile(m))
            if not matches and not _glob.has_magic(p):
                matches = [p]
        for m in matches:
            rp = os.path.realpath(m)
            if rp in seen:
                continue
            seen.add(rp)
            out.append(m)
    return out


def load_trace_files(paths: Sequence[str]) -> List[dict]:
    """Load and concatenate every file ``expand_inputs`` resolves from
    ``paths`` (records keep file order; files are visited in the expanded
    order, so a rotated set ``trace.json.0 .1 ...`` reads chronologically)."""
    records: List[dict] = []
    for path in expand_inputs(paths):
        records.extend(load_trace_file(path))
    return records


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
        # (perf_analyzer --export-metrics)
        return {"count": 0, "mean_us": None, "p50_us": None,
                "p90_us": None, "p99_us": None}
    return {
        "count": n,
        "mean_us": (sum(vals) / n) / 1e3,
        "p50_us": percentile(vals, 50) / 1e3,
        "p90_us": percentile(vals, 90) / 1e3,
        "p99_us": percentile(vals, 99) / 1e3,
    }


def summarize(server_records: List[dict],
              client_records: Optional[List[dict]] = None) -> Dict[str, Any]:
    """Aggregate trace records into the summary structure the text renderer
    (and ``--format json``) prints: per-model stage stats, queue share, and
    — when a client file is joined — network-overhead stats."""
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
    if client_records is not None:
        summary["join"] = _join(server_records, client_records)
        journeys = _journeys(server_records, client_records)
        if journeys is not None:
            summary["journeys"] = journeys
    return summary


_TRACEPARENT_RE = re.compile(
    r"\A[0-9a-f]{2}-([0-9a-f]{32})-[0-9a-f]{16}-[0-9a-f]{2}\Z")


def trace_id_of(rec: dict) -> str:
    """The 32-hex trace id of a record's ``traceparent``, or "".  The
    JOURNEY join key: client attempt records mint a fresh span id per
    attempt but share one trace id, so joining on the full traceparent
    would split one journey into its attempts."""
    m = _TRACEPARENT_RE.match(str(rec.get("traceparent", "")))
    return m.group(1) if m else ""


def _journeys(server_records: List[dict],
              client_records: List[dict]) -> Optional[Dict[str, Any]]:
    """Reconstruct request journeys: every client record (attempts, RETRY
    backoffs, HEDGE wins, BREAKER_OPEN/ENDPOINT_SWITCH events) and every
    server record (successes and refusals) carrying the same trace id is
    one caller-visible request's story.  Returns None when no client
    record carries a traceparent (pre-journey trace files)."""
    jmap: Dict[str, Dict[str, Any]] = {}
    for rec in client_records:
        tid = trace_id_of(rec)
        if not tid:
            continue
        j = jmap.setdefault(tid, {"attempts": [], "events": {}, "hedge_wins": 0})
        names = [str(s.get("name", "")) for s in rec.get("spans", [])]
        if "REQUEST" in names:
            j["attempts"].append(rec)
        elif "HEDGE" in names:
            # only hedge WINS are recorded (the backup answered first);
            # fired-but-lost hedges show up as overlapping attempts below
            j["hedge_wins"] += 1
        else:
            for name in names:
                j["events"][name] = j["events"].get(name, 0) + 1
    if not jmap:
        return None
    smap: Dict[str, List[dict]] = {}
    for rec in server_records:
        tid = trace_id_of(rec)
        if tid:
            smap.setdefault(tid, []).append(rec)

    def _request_span(rec: dict) -> Optional[Tuple[int, int]]:
        for name, start, end in record_spans(rec):
            if name == "REQUEST":
                return start, end
        return None

    complete = 0
    attempts_per_success: List[int] = []
    replica_counts: List[int] = []
    cross_replica = 0
    retry_added_ns: List[int] = []
    hedges_fired = 0
    hedge_wins = 0
    shed_journeys = 0
    shed_converted = 0
    event_totals: Dict[str, int] = {}
    for tid, j in jmap.items():
        spans = [(_request_span(a), bool(a.get("ok", True)))
                 for a in j["attempts"]]
        spans = [(iv, ok) for iv, ok in spans if iv is not None]
        success = any(ok for _, ok in spans)
        if success:
            complete += 1
            attempts_per_success.append(len(j["attempts"]))
            if len(spans) > 1:
                # wall-clock the retries added on the CLIENT clock: the
                # whole journey envelope (first attempt start -> last
                # attempt end, backoff sleeps included) minus the winning
                # attempt's own duration
                lo = min(s for (s, _), _ in spans)
                hi = max(e for (_, e), _ in spans)
                win = max(e - s for (s, e), ok in spans if ok)
                retry_added_ns.append(max(0, (hi - lo) - win))
        ordered = sorted(iv for iv, _ in spans)
        overlapped = any(b_start < a_end for (_, a_end), (b_start, _)
                        in zip(ordered, ordered[1:]))
        if overlapped or j["hedge_wins"]:
            hedges_fired += 1
        if j["hedge_wins"]:
            hedge_wins += 1
        sjoin = smap.get(tid, [])
        replicas = {str(r.get("replica", "")) for r in sjoin
                    if r.get("replica")}
        if replicas:
            replica_counts.append(len(replicas))
            if len(replicas) > 1:
                cross_replica += 1
        if any(r.get("refused") for r in sjoin):
            shed_journeys += 1
            if success:
                shed_converted += 1
        for name, count in j["events"].items():
            event_totals[name] = event_totals.get(name, 0) + count
    n = len(jmap)
    counts = sorted(attempts_per_success)
    return {
        "count": n,
        "complete": complete,
        "attempts_per_success": {
            "mean": (round(sum(counts) / len(counts), 2) if counts
                     else None),
            "p50": percentile(counts, 50) if counts else None,
            "p99": percentile(counts, 99) if counts else None,
            "max": counts[-1] if counts else None,
        },
        "replicas_per_journey": {
            "mean": (round(sum(replica_counts) / len(replica_counts), 2)
                     if replica_counts else None),
            "max": max(replica_counts) if replica_counts else None,
            "cross_replica_journeys": cross_replica,
        },
        "retry_added_us": _stage_stats(retry_added_ns),
        "hedge": {
            "fired": hedges_fired,
            "wins": hedge_wins,
            "win_rate_pct": (round(100.0 * hedge_wins / hedges_fired, 1)
                             if hedges_fired else None),
        },
        "sheds": {
            "journeys_shed": shed_journeys,
            "converted": shed_converted,
            "conversion_pct": (round(100.0 * shed_converted / shed_journeys,
                                     1) if shed_journeys else None),
        },
        "events": dict(sorted(event_totals.items())),
        # server trace ids with no client-side journey: traffic from
        # un-instrumented callers (or a client file that wasn't collected)
        "orphan_server_traces": sum(1 for t in smap if t not in jmap),
    }


def _join(server_records: List[dict],
          client_records: List[dict]) -> Dict[str, Any]:
    def request_dur(spans):
        for name, start, end in spans:
            if name == "REQUEST":
                return max(0, end - start)
        return None

    client_by_id: Dict[str, dict] = {}
    for rec in client_records:
        rid = str(rec.get("request_id", ""))
        if rid:
            client_by_id.setdefault(rid, rec)
    overhead_ns: List[int] = []
    joined = 0
    for rec in server_records:
        rid = str(rec.get("triton_request_id", ""))
        crec = client_by_id.get(rid)
        if crec is None:
            continue
        joined += 1
        sdur = request_dur(record_spans(rec))
        cdur = request_dur(
            [(s["name"], int(s["start_ns"]), int(s["end_ns"]))
             for s in crec.get("spans", [])])
        if sdur is not None and cdur is not None:
            overhead_ns.append(cdur - sdur)
    client_stages: Dict[str, List[int]] = {}
    for rec in client_records:
        for s in rec.get("spans", []):
            name = str(s["name"])
            if name == "REQUEST":
                continue
            client_stages.setdefault(name, []).append(
                max(0, int(s["end_ns"]) - int(s["start_ns"])))
    order = [s for s in CLIENT_STAGES if s in client_stages] + sorted(
        s for s in client_stages if s not in CLIENT_STAGES)
    return {
        "client_requests": len(client_records),
        "joined": joined,
        # wire + client-stack time invisible to the server: the honest
        # "how much latency is NOT the server" number
        "network_overhead_us": _stage_stats(overhead_ns),
        "client_stages": {name: _stage_stats(client_stages[name])
                          for name in order},
    }


# -- text rendering ---------------------------------------------------------

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
    join = summary.get("join")
    if join is not None:
        lines.append("")
        lines.append(
            f"== client join: {join['joined']}/{summary['requests']} server "
            f"trace(s) joined on request id ==")
        ov = join["network_overhead_us"]
        lines.append(
            "  network overhead (client REQUEST - server REQUEST): "
            f"count {ov['count']}  mean_us {_fmt_val(ov['mean_us'])}  "
            f"p50_us {_fmt_val(ov['p50_us'])}  "
            f"p99_us {_fmt_val(ov['p99_us'])}")
        lines.extend(
            _stage_table(list(join["client_stages"].items()), share=False))
    jo = summary.get("journeys")
    if jo is not None:
        lines.append("")
        lines.append(f"== journeys: {jo['count']} trace id(s), "
                     f"{jo['complete']} complete ==")
        a = jo["attempts_per_success"]
        lines.append(
            f"  attempts/success: mean {_fmt_val(a['mean'])}  "
            f"p50 {_fmt_val(a['p50'])}  p99 {_fmt_val(a['p99'])}  "
            f"max {a['max'] if a['max'] is not None else '-'}")
        r = jo["replicas_per_journey"]
        lines.append(
            f"  replicas/journey: mean {_fmt_val(r['mean'])}  "
            f"max {r['max'] if r['max'] is not None else '-'}  "
            f"cross-replica journeys {r['cross_replica_journeys']}")
        ra = jo["retry_added_us"]
        lines.append(
            f"  retry-added latency us ({ra['count']} multi-attempt "
            f"journey(s)): p50 {_fmt_val(ra['p50_us'])}  "
            f"p99 {_fmt_val(ra['p99_us'])}")
        h = jo["hedge"]
        lines.append(
            f"  hedges: fired {h['fired']}  wins {h['wins']}  "
            f"win rate {_fmt_val(h['win_rate_pct'])}%")
        s = jo["sheds"]
        lines.append(
            f"  sheds: {s['journeys_shed']} journey(s) shed, "
            f"{s['converted']} converted to success "
            f"({_fmt_val(s['conversion_pct'])}%)")
        if jo["events"]:
            lines.append("  events: " + "  ".join(
                f"{k}={v}" for k, v in jo["events"].items()))
        if jo["orphan_server_traces"]:
            lines.append(f"  orphan server traces (no client journey): "
                         f"{jo['orphan_server_traces']}")
    return "\n".join(lines) + "\n"


# -- Chrome trace-event export ----------------------------------------------

def chrome_trace(server_records: List[dict],
                 client_records: Optional[List[dict]] = None) -> Dict[str, Any]:
    """Chrome trace-event JSON (the object form: ``{"traceEvents": [...]}``)
    loadable in Perfetto / chrome://tracing.  Server and client records get
    separate pids (their monotonic clocks do not align); timestamps are
    rebased per source so the view starts at t=0.

    Stream records additionally render:

    * **token instants** (``FIRST_TOKEN`` / strided ``TOKEN[n]``) on the
      sequence's own lane, and
    * a **decode-worker pid** with one lane per (model, bucket) holding a
      span per fused dispatch (deduped on ``tick_seq`` across the traced
      sequences that rode it), occupancy in ``args``.

    Sequence lanes and tick lanes join on ``tick_seq`` — each sequence
    span carries its ``tick_seqs`` list, each tick span its ``tick_seq``
    — so pad-waste and prefill/decode interleaving read visually."""
    events: List[dict] = [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "server"}},
    ]

    # one shared base for EVERY server-side lane (request spans, token
    # instants, decode ticks live on the same monotonic clock — rebasing
    # them separately would break the visual tick<->sequence alignment
    # this view exists for)
    ticks: Dict[Tuple[str, int], dict] = {}
    starts = []
    for rec in server_records:
        starts.extend(s for _, s, _ in record_spans(rec))
        starts.extend(ns for _, ns in token_events(rec))
        model = str(rec.get("model_name", ""))
        for t in rec.get("ticks", []):
            if "tick_seq" in t:
                ticks.setdefault((model, int(t["tick_seq"])), t)
    starts.extend(int(t.get("start_ns", 0)) for t in ticks.values())
    base = min(starts) if starts else 0

    for rec in server_records:
        tid = int(rec.get("id", 0))
        args: Dict[str, Any] = {
            "model": rec.get("model_name", ""),
            "request_id": rec.get("triton_request_id", "")}
        seqs = sorted({int(t["tick_seq"]) for t in rec.get("ticks", [])
                       if "tick_seq" in t})
        if seqs:
            args["tick_seqs"] = seqs
        if "outcome" in rec:
            args["outcome"] = rec["outcome"]
        cost = rec.get("cost")
        for name, start, end in record_spans(rec):
            span_args = args
            if isinstance(cost, dict) and name in ("COMPUTE", "DECODE"):
                # cost stamps ride the device-time spans: click a
                # COMPUTE/DECODE slice in Perfetto and read who paid
                # for it and at what unit cost
                span_args = dict(args)
                for k in ("tenant", "device_us", "tokens"):
                    if k in cost:
                        span_args[f"cost_{k}"] = cost[k]
            events.append({
                "name": name,
                "ph": "X",
                "ts": (start - base) / 1e3,       # microseconds
                "dur": max(0, end - start) / 1e3,
                "pid": 1,
                "tid": tid,
                "cat": "server",
                "args": span_args,
            })
        for n, ns in token_events(rec):
            events.append({
                "name": "FIRST_TOKEN" if n == 0 else f"TOKEN[{n}]",
                "ph": "i",
                "s": "t",                         # thread-scoped instant
                "ts": (ns - base) / 1e3,
                "pid": 1,
                "tid": tid,
                "cat": "server",
                "args": {"token": n},
            })

    if ticks:
        events.append({"ph": "M", "name": "process_name", "pid": 3,
                       "args": {"name": "decode worker"}})
        lanes: Dict[Tuple[str, int], int] = {}
        for (model, seq), t in sorted(ticks.items()):
            lane = lanes.setdefault((model, int(t.get("bucket", 0))),
                                    len(lanes) + 1)
            events.append({
                "name": f"tick {seq}",
                "ph": "X",
                "ts": (int(t.get("start_ns", 0)) - base) / 1e3,
                "dur": max(0, int(t.get("end_ns", 0))
                           - int(t.get("start_ns", 0))) / 1e3,
                "pid": 3,
                "tid": lane,
                "cat": "tick",
                "args": {"model": model,
                         **{k: t[k] for k in ("tick_seq", "bucket", "batch",
                                              "padded", "steps", "requests")
                            if k in t}},
            })

    if client_records is not None:
        events.insert(1, {"ph": "M", "name": "process_name", "pid": 2,
                          "args": {"name": "client"}})
        tids: Dict[str, int] = {}
        cstarts = [s for rec in client_records
                   for _, s, _ in record_spans(rec)]
        cbase = min(cstarts) if cstarts else 0
        for rec in client_records:
            rid = str(rec.get("request_id", ""))
            ctid = tids.setdefault(rid, len(tids) + 1)
            for name, start, end in record_spans(rec):
                events.append({
                    "name": name,
                    "ph": "X",
                    "ts": (start - cbase) / 1e3,
                    "dur": max(0, end - start) / 1e3,
                    "pid": 2,
                    "tid": ctid,
                    "cat": "client",
                    "args": {"model": rec.get("model", ""),
                             "request_id": rid},
                })
        # journey lanes: one pid per trace id, the client's attempts on
        # lane 0 and one lane per replica the journey touched, all on ONE
        # rebased clock — each joined server record is shifted onto the
        # client clock by aligning its REQUEST start with the wire time of
        # the attempt that reached it (exact traceparent match)
        events.extend(_journey_lanes(server_records, client_records))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


#: first journey pid in the chrome export (server=1, client=2, decode
#: worker=3 — journeys start far above so added fixed pids never collide)
JOURNEY_PID_BASE = 100


def _journey_lanes(server_records: List[dict],
                   client_records: List[dict]) -> List[dict]:
    jmap: Dict[str, List[dict]] = {}
    for rec in client_records:
        tid = trace_id_of(rec)
        if tid:
            jmap.setdefault(tid, []).append(rec)
    if not jmap:
        return []
    smap: Dict[str, List[dict]] = {}
    for rec in server_records:
        tid = trace_id_of(rec)
        if tid:
            smap.setdefault(tid, []).append(rec)
    events: List[dict] = []
    pid = JOURNEY_PID_BASE
    for tid in sorted(jmap):
        crecs = jmap[tid]
        pid += 1
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "args": {"name": f"journey {tid[:8]}"}})
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": 0, "args": {"name": "client"}})
        cstarts = [s for rec in crecs for _, s, _ in record_spans(rec)]
        base = min(cstarts) if cstarts else 0
        # the wire anchor of each attempt: its NETWORK span start (fall
        # back to REQUEST start), keyed by the attempt's full traceparent
        anchors: Dict[str, int] = {}
        for rec in crecs:
            tp = str(rec.get("traceparent", ""))
            spans = {name: start for name, start, _ in record_spans(rec)}
            if tp and ("NETWORK" in spans or "REQUEST" in spans):
                anchors.setdefault(
                    tp, spans.get("NETWORK", spans.get("REQUEST", 0)))
        for rec in crecs:
            attempt = rec.get("attempt")
            for name, start, end in record_spans(rec):
                ev = {
                    "name": name,
                    "ts": (start - base) / 1e3,
                    "pid": pid,
                    "tid": 0,
                    "cat": "journey",
                    "args": {"model": rec.get("model", ""),
                             "request_id": rec.get("request_id", "")},
                }
                if attempt is not None:
                    ev["args"]["attempt"] = attempt
                if end > start:
                    ev.update(ph="X", dur=(end - start) / 1e3)
                else:
                    # zero-duration journey event (BREAKER_OPEN, ...)
                    ev.update(ph="i", s="t")
                events.append(ev)
        lanes: Dict[str, int] = {}
        for rec in smap.get(tid, []):
            spans = record_spans(rec)
            root = next((s for s in spans if s[0] == "REQUEST"), None)
            if root is None:
                continue
            anchor = anchors.get(str(rec.get("traceparent", "")))
            # server clock -> client clock: the attempt hit the wire at
            # `anchor`, the server opened its root at root start.  With no
            # exact attempt match the record sits at the journey origin.
            offset = (anchor - root[1]) if anchor is not None else (base - root[1])
            replica = str(rec.get("replica", "")) or "server"
            lane = lanes.get(replica)
            if lane is None:
                lane = lanes[replica] = len(lanes) + 1
                events.append({"ph": "M", "name": "thread_name",
                               "pid": pid, "tid": lane,
                               "args": {"name": replica}})
            args: Dict[str, Any] = {"model": rec.get("model_name", "")}
            for key in ("outcome", "shed_reason"):
                if key in rec:
                    args[key] = rec[key]
            for name, start, end in spans:
                ev = {
                    "name": ("REFUSED" if name == "REQUEST"
                             and rec.get("refused") else name),
                    "ts": (start + offset - base) / 1e3,
                    "pid": pid,
                    "tid": lane,
                    "cat": "journey",
                    "args": args,
                }
                if end > start:
                    ev.update(ph="X", dur=(end - start) / 1e3)
                else:
                    ev.update(ph="i", s="t")
                events.append(ev)
    return events


# -- CLI --------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="trace_summary",
        description="Summarize server trace files (per-model/per-stage "
                    "latency breakdown), join client trace files on "
                    "triton-request-id, export Chrome trace-event JSON.")
    parser.add_argument("server", nargs="+",
                        help="server trace file(s): literal paths, globs "
                        "('trace.json*' collects a rotated set), or "
                        "directories (every file inside); overlapping "
                        "specs are deduplicated by realpath")
    parser.add_argument("--client", action="append", default=None,
                        metavar="PATH",
                        help="client trace file(s) "
                        "(telemetry().enable_tracing); repeatable, each "
                        "a path/glob/directory — joined on "
                        "triton-request-id, and on the traceparent trace "
                        "id for the journeys report")
    parser.add_argument("--format", default="text",
                        choices=["text", "json", "chrome"],
                        help="text table (default), summary JSON, or Chrome "
                             "trace-event JSON for Perfetto")
    parser.add_argument("-o", "--output", default=None, metavar="PATH",
                        help="write to a file instead of stdout")
    parser.add_argument("-q", "--quiet", action="store_true",
                        help="no output, exit status only (scripted use; "
                             "-o files are still written)")
    args = parser.parse_args(argv)

    def fail(msg: str) -> int:
        # one line on stderr, nonzero exit — never an unhandled traceback
        # (a missing/empty trace file is an operator mistake, not a crash)
        if not args.quiet:
            print(f"error: {msg}", file=sys.stderr)
        return 1

    try:
        server_records = load_trace_files(args.server)
        client_records = (load_trace_files(args.client)
                          if args.client else None)
    except (OSError, ValueError) as e:
        return fail(str(e))
    if not server_records:
        return fail(f"{' '.join(args.server)}: empty trace file(s) — no "
                    "trace records (was trace_level=TIMESTAMPS set while "
                    "traffic ran?)")

    if args.format == "chrome":
        out = json.dumps(chrome_trace(server_records, client_records),
                         indent=2)
    elif args.format == "json":
        out = json.dumps(summarize(server_records, client_records), indent=2)
    else:
        out = format_text(summarize(server_records, client_records))
    if args.output:
        with open(args.output, "w") as f:
            f.write(out if out.endswith("\n") else out + "\n")
    elif not args.quiet:
        sys.stdout.write(out if out.endswith("\n") else out + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
