"""The port's trace-file tool (``tools/trace_summary.py``) against the
reference's, on the CPU.

* The same seeded JSON-Lines files -- server records in the span shape,
  in the legacy flat timestamps and in the token-event shape (stream
  records with ``FIRST_TOKEN`` / ``TOKEN[n]``, decode ticks, batcher
  ticks, cost stamps, refusals, replicas), and a client file whose
  attempts, retries, hedges and breaker events share the server records'
  trace ids -- go through both packages' ``summarize``, ``format_text``,
  ``chrome_trace`` and ``main`` (``text``, ``json``, ``chrome``, globbed
  inputs and directories, ``--client`` repeated, ``-o``, ``-q``, bad
  inputs).  The outputs are equal: dicts equal, text identical, Chrome
  JSON equal, the same exit codes and error lines.  The files carry
  H2D_TRANSFER spans in the reference's shape, and both tools print the
  row alike.
* End to end: the port's server (``ServerHarness``) serving ``simple``
  and the tiny ``longctx_tpu`` preset, with server tracing and the port's
  client telemetry tracing on.  The tool (in-process and as ``python -m``)
  counts exactly the requests sent, every journey joins a client record to
  a server record, and ``perf_analyzer --trace-file`` prints the tool's
  summary of its file.  The port's server writes no H2D_TRANSFER span
  (ROADMAP C): its summary has no H2D_TRANSFER entry, never one counted 0.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from triton_client_tpu.tools import trace_summary as jts
from triton_client_tpu_torch import grpc as tgrpc
from triton_client_tpu_torch import http as thttp
from triton_client_tpu_torch import perf_analyzer as tpa
from triton_client_tpu_torch._telemetry import telemetry
from triton_client_tpu_torch.models import language as tlang
from triton_client_tpu_torch.models import zoo as tzoo
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import ServerHarness
from triton_client_tpu_torch.tools import trace_summary as tts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_TOOLS = {"port": tts, "ref": jts}
_MODELS = ("simple", "longctx_tpu", "llama_decode", "bert_large")
_STAGES = ("DECODE", "QUEUE", "BATCH_ASSEMBLY", "H2D_TRANSFER", "COMPUTE",
           "D2H_TRANSFER", "SERIALIZE", "NETWORK_WRITE", "CACHE_HIT")


def _tid(rng) -> str:
    return "".join(f"{x:02x}" for x in rng.integers(0, 256, 16))


def _span_id(rng) -> str:
    return "".join(f"{x:02x}" for x in rng.integers(0, 256, 8))


def make_files(seed: int, n: int = 40):
    """(server records, client records) from ``seed``: every fifth a
    stream record with a token timeline and decode ticks, about a quarter
    of the rest legacy, the others span records; about one client journey
    per server record, some with several attempts and events, and server
    traces no client sent."""
    rng = np.random.default_rng(seed)
    tids = [_tid(rng) for _ in range(n)]
    server, client = [], []
    for i in range(n):
        model = _MODELS[int(rng.integers(0, len(_MODELS)))]
        t0 = int(rng.integers(10**9, 2 * 10**9))
        dur = int(rng.integers(10**5, 5 * 10**7))
        rid = f"req-{seed}-{i}"
        tid = tids[i] if rng.random() < 0.9 else _tid(rng)
        rec = {"id": i, "model_name": model, "model_version": "1",
               "triton_request_id": rid,
               "traceparent": f"00-{tid}-{_span_id(rng)}-01"}
        if rng.random() < 0.5:
            rec["replica"] = f"replica-{int(rng.integers(0, 3))}"
        kind = rng.random()
        if i % 5 == 0:  # a stream record
            model, kind = "llama_decode", 0.5
            rec["model_name"] = model
        if kind < 0.25:  # the legacy flat timestamps
            q = t0 + dur // 5
            c0, c1 = t0 + dur // 3, t0 + dur * 3 // 4
            rec["timestamps"] = [
                {"name": "REQUEST_START", "ns": t0},
                {"name": "QUEUE_START", "ns": q},
                {"name": "COMPUTE_START", "ns": c0},
                {"name": "COMPUTE_END", "ns": c1},
                {"name": "REQUEST_END", "ns": t0 + dur}]
        else:
            spans = [{"name": "REQUEST", "start_ns": t0,
                      "end_ns": t0 + dur, "parent": None}]
            at = t0
            for name in _STAGES:
                if rng.random() < 0.7:
                    d = int(rng.integers(0, dur // 8))
                    spans.append({"name": name, "start_ns": at,
                                  "end_ns": at + d, "parent": "REQUEST"})
                    at += d
            rec["spans"] = spans
            rec["timestamps"] = [{"name": "REQUEST_START", "ns": t0}]
            if model == "llama_decode" and kind < 0.7:
                ntok = int(rng.integers(1, 40))
                rec["tokens"] = ntok
                rec["outcome"] = str(rng.choice(
                    ["ok", "ok", "cancelled", "error: boom"]))
                step = int(rng.integers(10**5, 10**6))
                rec["timestamps"] += [{"name": "FIRST_TOKEN",
                                       "ns": t0 + step}]
                rec["timestamps"] += [
                    {"name": f"TOKEN[{k}]", "ns": t0 + step * (k + 1)}
                    for k in range(4, ntok, 4)]
                rec["timestamps"].append({"name": "TOKEN[x]", "ns": t0})
                rec["ticks"] = [
                    {"tick_seq": int(s), "bucket": int(rng.choice([1, 8])),
                     "start_ns": t0 + int(s) * step,
                     "end_ns": t0 + int(s) * step + step // 2,
                     "batch": int(rng.integers(1, 8)), "padded": 8,
                     "steps": 4, "requests": 2}
                    for s in rng.integers(0, 12, 3)]
            if rng.random() < 0.4:
                rec["tick"] = {"bucket": int(rng.choice([4, 8, 32])),
                               "batch": int(rng.integers(1, 32)),
                               "pad_fraction": float(rng.random()),
                               "queue_depth": int(rng.integers(0, 9)),
                               "assembly_us": float(rng.random() * 90)}
            if rng.random() < 0.4:
                rec["cost"] = {"tenant": str(rng.choice(["", "gold",
                                                         "bulk"])),
                               "device_us": float(rng.random() * 900),
                               "tokens": int(rng.integers(0, 50))}
            if rng.random() < 0.1:
                rec["refused"] = True
                rec["shed_reason"] = "queue"
        server.append(rec)
        if rng.random() < 0.85:
            c0 = int(rng.integers(10**9, 2 * 10**9))
            for attempt in range(int(rng.integers(1, 4))):
                cdur = dur + int(rng.integers(0, 10**6))
                client.append({
                    "request_id": rid if attempt == 0 else f"{rid}-{attempt}",
                    "model": model, "protocol": "http", "method": "infer",
                    "ok": bool(rng.random() < 0.8), "attempt": attempt,
                    "traceparent": (rec["traceparent"] if attempt == 0
                                    else f"00-{tid}-{_span_id(rng)}-01"),
                    "spans": [
                        {"name": "REQUEST", "start_ns": c0,
                         "end_ns": c0 + cdur},
                        {"name": "SERIALIZE", "start_ns": c0,
                         "end_ns": c0 + 1000},
                        {"name": "NETWORK", "start_ns": c0 + 1000,
                         "end_ns": c0 + cdur - 500},
                        {"name": "DESERIALIZE", "start_ns": c0 + cdur - 500,
                         "end_ns": c0 + cdur}]})
                c0 += cdur - int(rng.integers(0, cdur // 2))
            for event in ("RETRY", "HEDGE", "BREAKER_OPEN",
                          "ENDPOINT_SWITCH"):
                if rng.random() < 0.2:
                    client.append({
                        "request_id": rid, "model": model,
                        "protocol": "grpc",
                        "traceparent": f"00-{tid}-{_span_id(rng)}-01",
                        "spans": [{"name": event, "start_ns": c0,
                                   "end_ns": c0 + (0 if event ==
                                                   "BREAKER_OPEN" else 50)}]})
    client.append({"request_id": "untraced", "model": "simple",
                   "spans": [{"name": "REQUEST", "start_ns": 5,
                              "end_ns": 9}]})
    return server, client


def _write(path, records) -> str:
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
        f.write("\n")  # a blank line is skipped
    return str(path)


SEEDS = [0, 1, 2, 3]


@pytest.mark.parametrize("with_client", [False, True],
                         ids=["server", "joined"])
@pytest.mark.parametrize("seed", SEEDS)
def test_summary_and_text_equal(seed, with_client):
    server, client = make_files(seed)
    client = client if with_client else None
    summary = tts.summarize(server, client)
    assert summary == jts.summarize(server, client)
    assert tts.format_text(summary) == jts.format_text(summary)
    assert "H2D_TRANSFER" in tts.format_text(summary)
    if with_client:
        assert summary["journeys"]["count"] > 0
        assert summary["join"]["joined"] > 0


@pytest.mark.parametrize("with_client", [False, True],
                         ids=["server", "joined"])
@pytest.mark.parametrize("seed", SEEDS)
def test_chrome_trace_equal(seed, with_client):
    server, client = make_files(seed)
    client = client if with_client else None
    got = tts.chrome_trace(server, client)
    assert got == jts.chrome_trace(server, client)
    pids = {e["pid"] for e in got["traceEvents"]}
    assert 3 in pids  # the decode worker's lanes
    if with_client:
        assert max(pids) > tts.JOURNEY_PID_BASE  # the journey lanes


@pytest.mark.parametrize("seed", SEEDS)
def test_record_helpers_equal(seed):
    server, client = make_files(seed)
    for rec in server + client:
        assert tts.record_spans(rec) == jts.record_spans(rec)
        assert tts.token_events(rec) == jts.token_events(rec)
        assert tts.trace_id_of(rec) == jts.trace_id_of(rec)
    for p in (0, 1, 50, 90, 99, 100):
        assert tts.percentile(list(range(7)), p) == \
            jts.percentile(list(range(7)), p)


def _main(pkg, argv, capsys):
    rc = _TOOLS[pkg].main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("client", [False, True], ids=["server", "joined"])
@pytest.mark.parametrize("fmt", ["text", "json", "chrome"])
def test_main_equal(fmt, client, tmp_path, capsys):
    server, crecs = make_files(7)
    spath = _write(tmp_path / "server.json", server)
    half = len(crecs) // 2
    args = [spath, "--format", fmt]
    if client:
        args += ["--client", _write(tmp_path / "c0.json", crecs[:half]),
                 "--client", _write(tmp_path / "c1.json", crecs[half:])]
    got = {pkg: _main(pkg, args, capsys) for pkg in _TOOLS}
    assert got["port"] == got["ref"]
    rc, out, err = got["port"]
    assert rc == 0 and err == "" and out.endswith("\n")
    if fmt != "text":
        json.loads(out)
    # -o writes the same file; -q prints nothing
    files = {}
    for pkg in _TOOLS:
        files[pkg] = tmp_path / f"{pkg}.out"
        assert _main(pkg, args + ["-o", str(files[pkg]), "-q"],
                     capsys) == (0, "", "")
    assert files["port"].read_text() == files["ref"].read_text() == out


def test_globs_directories_and_rotated_sets(tmp_path, capsys):
    server, client = make_files(11, n=30)
    d = tmp_path / "traces"
    d.mkdir()
    for k in range(3):
        _write(d / f"trace.json.{k}", server[k * 10:(k + 1) * 10])
    cdir = tmp_path / "client"
    cdir.mkdir()
    _write(cdir / "c.json", client)
    specs = [str(d), str(d / "trace.json*"), str(d / "trace.json.1")]
    assert tts.expand_inputs(specs) == jts.expand_inputs(specs)
    assert len(tts.expand_inputs(specs)) == 3  # overlaps count once
    assert len(tts.load_trace_files(specs)) == 30
    for fmt in ("text", "json"):
        args = [*specs, "--client", str(cdir), "--format", fmt]
        got = {pkg: _main(pkg, args, capsys) for pkg in _TOOLS}
        assert got["port"] == got["ref"] and got["port"][0] == 0
    summary = json.loads(got["port"][1])
    assert summary["requests"] == 30
    assert summary == tts.summarize(server, client)


@pytest.mark.parametrize("case", ["missing", "malformed", "not_object",
                                  "empty", "bad_client", "no_match"])
@pytest.mark.parametrize("quiet", [False, True], ids=["loud", "quiet"])
def test_bad_inputs(case, quiet, tmp_path, capsys):
    good = _write(tmp_path / "good.json", make_files(3, n=5)[0])
    path = str(tmp_path / "bad.json")
    if case == "malformed":
        with open(path, "w") as f:
            f.write('{"id": 1}\n{not json\n')
    elif case == "not_object":
        with open(path, "w") as f:
            f.write("[1, 2]\n")
    elif case in ("empty", "no_match"):
        open(path, "w").close()
    args = ([good, "--client", path] if case == "bad_client"
            else [str(tmp_path / "none*.json")] if case == "no_match"
            else [path])
    if quiet:
        args.append("-q")
    got = {pkg: _main(pkg, args, capsys) for pkg in _TOOLS}
    assert got["port"] == got["ref"]
    rc, out, err = got["port"]
    assert rc == 1 and out == ""
    if quiet:
        assert err == ""
    else:
        assert err.startswith("error: ") and err.count("\n") == 1


# -- end to end on the port's server -----------------------------------------

@pytest.fixture(scope="module")
def served():
    registry = ModelRegistry()
    for m in (tzoo.make_simple(), tlang.make_longctx_tpu("cpu")):
        registry.register_model(m)
    with ServerHarness(registry) as h:
        yield h


def _simple_inputs(mod, rng):
    a = rng.integers(-9, 9, (1, 16)).astype(np.int32)
    ins = []
    for name in ("INPUT0", "INPUT1"):
        i = mod.InferInput(name, [1, 16], "INT32")
        i.set_data_from_numpy(a)
        ins.append(i)
    return ins


def _longctx_inputs(rng):
    s = tlang.longctx_seq_len("cpu")
    x = rng.integers(0, 256, (2, s)).astype(np.int32)
    i = thttp.InferInput("TOKENS", list(x.shape), "INT32")
    i.set_data_from_numpy(x)
    return [i]


def _trace(url, path, level):
    with thttp.InferenceServerClient(url) as c:
        c.update_trace_settings(settings={
            "trace_file": [str(path)], "trace_level": [level],
            "trace_rate": ["1"], "trace_count": ["-1"],
            "log_frequency": ["0"]})


def test_the_tool_reads_the_ports_traces(served, tmp_path, capsys):
    spath, cpath = tmp_path / "server.json", tmp_path / "client.json"
    rng = np.random.default_rng(5)
    _trace(served.http_url, spath, "TIMESTAMPS")
    telemetry().enable_tracing(str(cpath))
    sent = {"simple": 0, "longctx_tpu": 0}
    try:
        with thttp.InferenceServerClient(served.http_url) as c:
            for _ in range(5):
                c.infer("simple", _simple_inputs(thttp, rng))
                sent["simple"] += 1
            for _ in range(2):
                c.infer("longctx_tpu", _longctx_inputs(rng))
                sent["longctx_tpu"] += 1
        with tgrpc.InferenceServerClient(served.http_url) as g:
            for _ in range(3):
                g.infer("simple", _simple_inputs(tgrpc, rng))
                sent["simple"] += 1
    finally:
        telemetry().disable_tracing()
        _trace(served.http_url, spath, "OFF")
    n = sum(sent.values())
    server = tts.load_trace_file(str(spath))
    client = tts.load_trace_file(str(cpath))
    summary = tts.summarize(server, client)
    assert summary == jts.summarize(server, client)
    assert summary["requests"] == n
    assert {m: e["count"] for m, e in summary["models"].items()} == sent
    assert summary["join"]["joined"] == n
    jo = summary["journeys"]
    assert (jo["count"], jo["complete"], jo["orphan_server_traces"]) == \
        (n, n, 0)
    # the port writes no H2D_TRANSFER span: no entry, never a count of 0
    for entry in summary["models"].values():
        assert "H2D_TRANSFER" not in entry["stages"]
        assert {"QUEUE", "COMPUTE", "SERIALIZE"} <= set(entry["stages"])
    text = tts.format_text(summary)
    assert "H2D_TRANSFER" not in text and text == jts.format_text(summary)
    # as a CLI, in a process of its own (standard library only)
    proc = subprocess.run(
        [sys.executable, "-m", "triton_client_tpu_torch.tools.trace_summary",
         str(spath), "--client", str(cpath), "--format", "json"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == json.loads(json.dumps(summary))
    chrome = tts.chrome_trace(server, client)
    lanes = [e for e in chrome["traceEvents"]
             if e["pid"] > tts.JOURNEY_PID_BASE and e.get("ph") == "X"]
    assert {e["tid"] for e in lanes} >= {0, 1}  # client and server lanes
    # every response of the run went through the wire templates
    for cache in (served.core.http_wire_templates,
                  served.core.grpc_wire_templates):
        assert cache.stats["errors"] == 0 and cache.stats["hits"] > 0


def test_perf_analyzer_prints_the_tools_summary(served, tmp_path, capsys):
    path = tmp_path / "pa.json"
    rc = tpa.main(["-m", "simple", "-u", served.http_url,
                   "--concurrency-range", "1:1",
                   "--measurement-interval", "300",
                   "--trace-file", str(path), "--trace-rate", "1"])
    out = capsys.readouterr().out
    assert rc == 0, out
    marker = "*** Server trace breakdown"
    assert marker in out
    printed = out.split(marker, 1)[1].split("\n", 1)[1]
    assert tts.main([str(path)]) == 0
    assert capsys.readouterr().out == printed
    assert json.loads(json.dumps(tts.summarize(
        tts.load_trace_file(str(path)))))["requests"] > 0
