"""A postmortem from an incident bundle, as text.

``server/incident.py`` writes a bundle directory when a trigger fires;
this tool renders one for the operator who reads it::

    python -m triton_client_tpu_torch.tools.incident_report <bundle>
    python -m triton_client_tpu_torch.tools.incident_report --latest <dir>

The report is the reference tool's, line for line
(``triton_client_tpu/tools/incident_report.py``), in the order one
triages: the header (trigger, reason, time, process, files captured and
failed), the trigger timeline, the host profile of the capture window
per thread role with the lag probes and GC pauses, the models with most
device time and their roofline verdicts, the pinned flights, the memory
governor and the process's fingerprint.

Standard library only: a bundle is JSON and text, and may be read on a
machine without the server's packages.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

#: stacks shown per thread role
TOP_STACKS = 5
#: pinned flights shown
TOP_FLIGHTS = 12
#: models shown
TOP_MODELS = 8

_RULE = "=" * 72


def _read_json(bundle: str, name: str) -> Optional[Any]:
    try:
        with open(os.path.join(bundle, name), encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _read_text(bundle: str, name: str) -> Optional[str]:
    try:
        with open(os.path.join(bundle, name), encoding="utf-8") as f:
            return f.read()
    except OSError:
        return None


def parse_folded(text: str) -> List[Tuple[str, str, int]]:
    """Collapsed-stack lines (``role;frame;frame N``) as ``[(role, stack,
    samples)]``, most samples first; a line without a count is skipped."""
    out: List[Tuple[str, str, int]] = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        stack, _, count = line.rpartition(" ")
        try:
            n = int(count)
        except ValueError:
            continue
        role, _, frames = stack.partition(";")
        out.append((role, frames, n))
    out.sort(key=lambda t: -t[2])
    return out


def _when(ts: Optional[float]) -> str:
    if not ts:
        return "?"
    return time.strftime("%Y-%m-%d %H:%M:%S", time.gmtime(ts)) + "Z"


def _leaf(stack: str, keep: int = 3) -> str:
    """A folded stack's last ``keep`` frames, the part a table shows."""
    frames = stack.split(";")
    tail = ";".join(frames[-keep:])
    return "...;" + tail if len(frames) > keep else tail


def _heading(title: str) -> List[str]:
    return ["", title, "-" * len(title)]


def _header(bundle: str, manifest: dict) -> List[str]:
    trigger = manifest.get("trigger", "?")
    name = os.path.basename(bundle.rstrip(os.sep))
    reason = manifest.get("reason")
    out = [_RULE, f"INCIDENT POSTMORTEM — {name}", _RULE,
           f"trigger:  {trigger}" + (f" — {reason}" if reason else ""),
           f"when:     {manifest.get('iso') or _when(manifest.get('ts'))}"]
    replica = manifest.get("replica")
    out.append(f"process:  pid {manifest.get('pid', '?')}"
               + (f"  replica {replica}" if replica else ""))
    cap = manifest.get("capture") or {}
    if cap:
        out.append(f"capture:  {cap.get('profile_hz', '?')} Hz profile "
                   f"over {cap.get('profile_window_s', '?')}s window")
    files = manifest.get("files", [])
    failed = [(f["name"], f["error"]) for f in files if "error" in f]
    out.append(f"files:    {len(files) - len(failed)} captured"
               + (f", {len(failed)} FAILED" if failed else ""))
    out.extend(f"          ! {name}: {err}" for name, err in failed)
    return out


def _timeline(bundle: str, manifest: dict) -> List[str]:
    incident = _read_json(bundle, "incident.json") or {}
    out = _heading("Trigger timeline")
    for entry in list(incident.get("recent") or [])[-10:]:
        out.append(f"  {_when(entry.get('ts'))}  "
                   f"{entry.get('trigger', '?'):<15} "
                   f"{entry.get('reason', '')}"
                   f"  -> {entry.get('bundle', '')}")
    out.append(f"  {_when(manifest.get('ts'))}  "
               f"{manifest.get('trigger', '?'):<15} "
               f"{manifest.get('reason', '')}  -> THIS BUNDLE")
    suppressed = incident.get("suppressed") or {}
    if suppressed:
        held = ", ".join(f"{k}={v}" for k, v in sorted(suppressed.items()))
        out.append(f"  (rate-limited away before this point: {held})")
    return out


def _host_profile(bundle: str) -> List[str]:
    out = _heading("Host profile (capture window)")
    folded = _read_text(bundle, "profile.folded")
    if not folded:
        out.append("  (no profile captured)")
    else:
        stacks = parse_folded(folded)
        total = sum(n for _, _, n in stacks) or 1
        by_role: Dict[str, List[Tuple[str, int]]] = {}
        for role, stack, n in stacks:
            by_role.setdefault(role, []).append((stack, n))
        weight = {r: sum(n for _, n in v) for r, v in by_role.items()}
        for role in sorted(by_role, key=lambda r: -weight[r]):
            out.append(f"  [{role}] {weight[role]} samples "
                       f"({100.0 * weight[role] / total:.0f}%)")
            out.extend(f"    {n:>6}  {_leaf(stack)}"
                       for stack, n in by_role[role][:TOP_STACKS])
    profiler = _read_json(bundle, "profiler.json") or {}
    lags = profiler.get("loop_lag") or {}
    if lags:
        out.append("  event-loop lag:")
        for name, st in sorted(lags.items()):
            series = st.get("series") or []
            worst = max((p.get("lag_us", 0.0) for p in series),
                        default=st.get("max_us", 0.0))
            out.append(f"    {name}: last {st.get('last_us', 0.0):.0f}us"
                       f"  window-max {st.get('max_us', 0.0):.0f}us"
                       f"  series-max {worst:.0f}us"
                       f" over {len(series)} probes")
    gc_info = profiler.get("gc") or {}
    if gc_info:
        out.append("  GC pauses: " + "  ".join(
            f"gen{g}: {v.get('pause_us_total', 0.0) / 1e3:.1f}ms"
            f"/{v.get('collections', 0)} collections"
            for g, v in sorted(gc_info.items())))
    return out


def _verdicts(ticks: dict) -> List[str]:
    out = []
    for bucket, entry in sorted(ticks.items()):
        roof = entry.get("roofline") if isinstance(entry, dict) else None
        if not roof:
            continue
        kind = "comp" if roof.get("verdict", "?") == "compute_bound" \
            else "mem"
        pct = roof.get("pct_of_peak")
        out.append(f"@{bucket}:{kind}"
                   + (f" {pct:.0f}%" if pct is not None else ""))
    return out


def _models(bundle: str) -> List[str]:
    out = _heading("Hottest models (device time, roofline)")
    costs = _read_json(bundle, "costs.json") or {}
    device = _read_json(bundle, "device_stats.json") or {}
    per_model = {m: sum(float(c.get("device_us", 0.0))
                        for c in tenants.values() if isinstance(c, dict))
                 for m, tenants in (costs.get("models") or {}).items()}
    if not per_model:
        out.append("  (no cost ledger data)")
        return out
    ticks = device.get("ticks") or {}
    for m, us in sorted(per_model.items(),
                        key=lambda kv: -kv[1])[:TOP_MODELS]:
        verdicts = _verdicts(ticks.get(m) or {})
        out.append(f"  {m:<24}{us / 1e3:>10.1f} ms device"
                   + ("  " + " ".join(verdicts) if verdicts else ""))
    return out


def _flights(bundle: str) -> List[str]:
    out = _heading("Pinned flights (outliers at capture)")
    recorder = _read_json(bundle, "flight_recorder.json") or {}
    outliers = list(recorder.get("outliers") or [])
    if not outliers:
        out.append("  (no pinned flights)")
        return out
    out.append(f"  {'SEQ':>6}  {'MODEL':<20}{'TOTALms':>9}"
               f"{'AGEs':>7}  {'REASON':<14}{'OUTCOME':<10}CHAOS")
    for o in outliers[-TOP_FLIGHTS:]:
        total_ms = (o.get("total_us") or 0.0) / 1e3
        out.append(f"  {o.get('seq', '?'):>6}  {o.get('model', '?'):<20}"
                   f"{total_ms:>9.2f}{(o.get('age_s') or 0):>7.1f}  "
                   f"{(o.get('capture_reason') or '-'):<14}"
                   f"{(o.get('outcome') or '?'):<10}"
                   f"{o.get('chaos') or '-'}")
    return out


def _memory(bundle: str) -> List[str]:
    memory = _read_json(bundle, "memory.json") or {}
    if not memory:
        return []
    out = _heading("Memory governor")
    budget = memory.get("budget_bytes")
    live = memory.get("effective_budget_bytes", budget)
    out.append(f"  budget: {budget or 'unbounded'}"
               + (f"  effective: {live}" if live != budget else "")
               + ("  [PRESSURE ACTIVE]"
                  if memory.get("pressure_active") else ""))
    if memory.get("pressure_events"):
        out.append(f"  pressure windows seen: {memory['pressure_events']}")
    inflight = memory.get("inflight_by_model") or {}
    for m, b in sorted(inflight.items(), key=lambda kv: -kv[1])[:5]:
        out.append(f"  inflight {m}: {b} bytes")
    if memory.get("shed_total"):
        out.append(f"  shed: {memory['shed_total']} total")
    return out


def _fingerprint(bundle: str) -> List[str]:
    config = _read_json(bundle, "config.json") or {}
    if not config:
        return []
    out = _heading("Process fingerprint")
    out.append(f"  python {config.get('python', '?')} on "
               f"{config.get('platform', '?')}")
    env = config.get("env") or {}
    out.extend(f"  {k}={env[k]}" for k in sorted(env))
    return out


def render_report(bundle: str) -> str:
    """The postmortem of one bundle directory."""
    manifest = _read_json(bundle, "manifest.json") or {}
    lines = (_header(bundle, manifest) + _timeline(bundle, manifest)
             + _host_profile(bundle) + _models(bundle) + _flights(bundle)
             + _memory(bundle) + _fingerprint(bundle))
    lines.append("")
    return "\n".join(lines)


def find_latest(incident_dir: str) -> Optional[str]:
    """The newest bundle of an incident directory (names sort by time)."""
    try:
        entries = sorted(
            e for e in os.listdir(incident_dir)
            if e.startswith("incident-")
            and os.path.isdir(os.path.join(incident_dir, e)))
    except OSError:
        return None
    return os.path.join(incident_dir, entries[-1]) if entries else None


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m triton_client_tpu_torch.tools.incident_report",
        description="render an incident bundle into a postmortem")
    ap.add_argument("bundle", help="a bundle directory (with --latest, the "
                    "incident directory that holds bundles)")
    ap.add_argument("--latest", action="store_true",
                    help="render the newest bundle of the directory BUNDLE")
    ap.add_argument("-o", "--output", default=None,
                    help="write the report to this file, not stdout")
    args = ap.parse_args(argv)
    bundle = args.bundle
    if args.latest:
        bundle = find_latest(args.bundle)
        if bundle is None:
            print(f"no bundles under {args.bundle}", file=sys.stderr)
            return 1
    if not os.path.isfile(os.path.join(bundle, "manifest.json")):
        print(f"{bundle}: not an incident bundle (no manifest.json)",
              file=sys.stderr)
        return 1
    report = render_report(bundle)
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(report)
    else:
        sys.stdout.write(report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
