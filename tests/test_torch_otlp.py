"""The port's OTLP export (``triton_client_tpu_torch/otlp.py``) against the
JAX package's, on the CPU.

* ``derive_span_id``, ``split_traceparent`` and ``normalize_endpoint``
  equal the reference's;
* ``encode_server_record`` and ``encode_client_record`` of the same
  records give byte-identical JSON in both packages: records drawn from a
  seed (valid, malformed and all-zero traceparents, parents by name,
  unclosed spans, refusals, failed attempts), and the records the port's
  own tracer and client write for served requests;
* the exporter against a stub collector (an ``http.server`` thread): every
  record arrives, a full queue drops and counts, a dead collector counts
  errors, and a shut-down exporter takes no more and leaves no thread;
* end to end: a port server with ``enable_otlp`` and the port's client
  with ``telemetry().enable_otlp``: the collector holds every served
  request's server spans, each server root is the child of the client's
  REQUEST span on one trace id, and ``nv_otlp_export_total{outcome="ok"}``
  equals the posts that arrived with ``nv_otlp_dropped_total`` at 0.
"""

import http.server
import json
import threading
import time
import urllib.request

import numpy as np
import pytest

from triton_client_tpu import otlp as jotlp
from triton_client_tpu_torch import _telemetry as ttel
from triton_client_tpu_torch import http as thttp
from triton_client_tpu_torch import otlp as totlp
from triton_client_tpu_torch.models import zoo as tzoo
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import ServerHarness, free_port


class Collector:
    """A stub OTLP/HTTP collector: every POST's JSON body, kept."""

    def __init__(self):
        bodies = self.bodies = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                bodies.append((self.path, json.loads(self.rfile.read(n))))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *args):
                pass

        self.srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"127.0.0.1:{self.srv.server_address[1]}"
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()

    def spans(self):
        return [span for _path, body in self.bodies
                for rs in body["resourceSpans"]
                for ss in rs["scopeSpans"] for span in ss["spans"]]

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=10)


@pytest.fixture
def collector():
    c = Collector()
    yield c
    c.close()


def _hex(rng, n):
    return "".join(rng.choice(list("0123456789abcdef"), n))


def _traceparent(rng, i):
    kind = i % 4
    if kind == 0:
        return f"00-{_hex(rng, 32)}-{_hex(rng, 16)}-01"
    if kind == 1:
        return ""
    if kind == 2:
        return "00-" + "0" * 32 + f"-{_hex(rng, 16)}-01"  # invalid
    return "garbage"


def _server_record(rng, i):
    names = ["REQUEST", "QUEUE", "COMPUTE", "COMPUTE_INPUT", "SERIALIZE"]
    t = int(rng.integers(1e9, 1e12))
    spans = []
    for j, name in enumerate(names[:1 + i % len(names)]):
        start = t + j * 1000
        parent = None if j == 0 else names[int(rng.integers(0, j))]
        if j == 3 and i % 3 == 0:
            parent = "NO_SUCH_PARENT"
        spans.append({"name": name, "start_ns": start,
                      "end_ns": None if (i + j) % 7 == 0 else start + 500,
                      "parent": parent})
    rec = {"id": i, "model_name": f"m{i % 3}", "model_version": str(i % 2),
           "spans": spans, "traceparent": _traceparent(rng, i)}
    for key, value in (("replica", f"127.0.0.1:{8000 + i}"),
                       ("triton_request_id", f"rid-{i}"),
                       ("tenant", "gold"),
                       ("outcome", ["ok", "shed", "cancelled", "error",
                                    "success", ""][i % 6]),
                       ("shed_reason", "tier"), ("status", 429)):
        if rng.random() < 0.6:
            rec[key] = value
    return rec


def _client_record(rng, i):
    t = int(rng.integers(1e9, 1e12))
    rec = {"request_id": f"c{i}", "model": "simple", "protocol": "http",
           "method": ["infer", "async_infer", "", None][i % 4],
           "ok": bool(i % 3),
           "spans": [{"name": n, "start_ns": t + k, "end_ns": t + 10 * k}
                     for k, n in enumerate(["REQUEST", "SERIALIZE",
                                            "NETWORK", "DESERIALIZE",
                                            "RETRY"][:1 + i % 5])],
           "traceparent": _traceparent(rng, i)}
    if i % 2:
        rec["attempt"] = 1 + i % 3
    if i % 5 == 0:
        rec["endpoint"] = "127.0.0.1:9"
    return rec


def _same_json(port_fn, ref_fn, record, offset):
    a = json.dumps(port_fn(record, offset))
    b = json.dumps(ref_fn(record, offset))
    assert a == b, record
    return a


@pytest.mark.parametrize("seed", range(4))
def test_encodings_are_byte_identical_on_seeded_records(seed):
    rng = np.random.default_rng(seed)
    offset = int(rng.integers(0, 1 << 60))
    for i in range(40):
        _same_json(totlp.encode_server_record, jotlp.encode_server_record,
                   _server_record(rng, i), offset)
        _same_json(totlp.encode_client_record, jotlp.encode_client_record,
                   _client_record(rng, i), offset)


def test_ids_and_endpoints_equal_reference():
    rng = np.random.default_rng(3)
    for _ in range(50):
        parts = [_hex(rng, int(rng.integers(0, 40)))
                 for _ in range(int(rng.integers(1, 5)))]
        assert totlp.derive_span_id(*parts) == jotlp.derive_span_id(*parts)
    for tp in ("00-" + "a" * 32 + "-" + "b" * 16 + "-01", "", "x",
               "00-" + "0" * 32 + "-" + "b" * 16 + "-01",
               "00-" + "a" * 32 + "-" + "0" * 16 + "-01",
               "00-" + "A" * 32 + "-" + "b" * 16 + "-01"):
        assert totlp.split_traceparent(tp) == jotlp.split_traceparent(tp)
    for ep in ("localhost:4318", "http://c:4318", "https://c/v1/x",
               " c:1 "):
        assert totlp.normalize_endpoint(ep) == jotlp.normalize_endpoint(ep)
    for bad in ("", "  "):
        for mod in (totlp, jotlp):
            with pytest.raises(ValueError, match="empty OTLP endpoint"):
                mod.normalize_endpoint(bad)
    env = totlp.encode_resource_spans([], "svc", {"replica": "r", "a": 1})
    ref = jotlp.encode_resource_spans([], "svc", {"replica": "r", "a": 1})
    assert env["resourceSpans"][0]["resource"] == \
        ref["resourceSpans"][0]["resource"]


def _served_records(tmp_path):
    """The records the port's tracer and client write for served
    requests (two answered, one refused at admission)."""
    registry = ModelRegistry()
    registry.register_model(tzoo.make_simple())
    trace = tmp_path / "server.jsonl"
    client = tmp_path / "client.jsonl"
    tel = ttel.telemetry()
    with ServerHarness(registry, replica="r0") as h:
        with thttp.InferenceServerClient(h.http_url) as c:
            c.update_trace_settings(settings={
                "trace_file": [str(trace)], "trace_level": ["TIMESTAMPS"],
                "trace_rate": ["1"]})
            tel.enable_tracing(str(client))
            try:
                a = np.arange(16, dtype=np.int32).reshape(1, 16)
                ins = []
                for name in ("INPUT0", "INPUT1"):
                    i = thttp.InferInput(name, [1, 16], "INT32")
                    i.set_data_from_numpy(a)
                    ins.append(i)
                c.infer("simple", ins, request_id="one")
                c.infer("simple", ins)
            finally:
                tel.disable_tracing()
            h.core.tracer.record_refusal(
                "simple", shed_reason="queue_full", status=429,
                tenant="t", protocol="http", client_request_id="r",
                traceparent="00-" + "c" * 32 + "-" + "d" * 16 + "-01")
            c.update_trace_settings(settings={"trace_level": ["OFF"]})

    def lines(path):
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            out = [json.loads(x) for x in open(path) if x.strip()]
            if len(out) >= 3 or path == client:
                return out
            time.sleep(0.02)
        return [json.loads(x) for x in open(path) if x.strip()]

    return lines(trace), lines(client)


def test_encodings_are_byte_identical_on_served_records(tmp_path):
    server, client = _served_records(tmp_path)
    assert len(server) == 3 and len(client) == 2
    assert all(r.get("replica") == "r0" for r in server)
    for rec in server:
        out = json.loads(_same_json(totlp.encode_server_record,
                                    jotlp.encode_server_record, rec, 7))
        assert out
    for rec in client:
        out = json.loads(_same_json(totlp.encode_client_record,
                                    jotlp.encode_client_record, rec, 7))
        assert [s["kind"] for s in out].count(totlp.SPAN_KIND_CLIENT) == 1


def test_exporter_delivers_every_record(collector):
    exp = totlp.OtlpExporter(collector.url, "svc",
                             totlp.encode_client_record, batch_max=4,
                             flush_interval_s=0.05)
    rng = np.random.default_rng(0)
    records = [_client_record(rng, i) for i in range(10)]
    for r in records:
        exp.submit(r)
    assert exp.flush(10)
    exp.shutdown()
    assert not exp._thread.is_alive()
    want = sum(len(totlp.encode_client_record(r)) for r in records)
    assert len(collector.spans()) == want
    assert {p for p, _ in collector.bodies} == {"/v1/traces"}
    c = exp.counters()
    assert c == {"ok": len(collector.bodies), "error": 0, "dropped": 0}
    assert c["ok"] >= 3  # batches of at most 4


def test_exporter_drops_on_a_full_queue_and_counts_errors(collector):
    dead = f"127.0.0.1:{free_port()}"  # nothing listens
    exp = totlp.OtlpExporter(dead, "svc", totlp.encode_client_record,
                             queue_size=3, timeout_s=2.0)
    rng = np.random.default_rng(1)
    for i in range(10):
        exp.submit(_client_record(rng, i))
    assert exp.counters()["dropped"] == 7
    assert exp.flush(10)
    assert exp.counters()["error"] >= 1 and exp.counters()["ok"] == 0
    exp.shutdown()
    exp.submit(_client_record(rng, 11))  # after shutdown: a drop
    assert exp.counters()["dropped"] == 8
    assert not exp._thread.is_alive()


def test_a_record_whose_encoding_raises_counts_an_error(collector):
    exp = totlp.OtlpExporter(collector.url, "svc",
                             lambda r, off: 1 / 0)
    exp.submit({"x": 1})
    assert exp.flush(10)
    exp.shutdown()
    assert exp.counters() == {"ok": 0, "error": 1, "dropped": 0}
    assert collector.bodies == []


def test_server_and_client_spans_join_at_the_collector(collector,
                                                       tmp_path):
    registry = ModelRegistry()
    registry.register_model(tzoo.make_simple())
    tel = ttel.telemetry()
    n = 6
    with ServerHarness(registry, replica="r1") as h:
        h.core.enable_otlp(collector.url, replica="r1")
        exporter = tel.enable_otlp(collector.url)
        try:
            with thttp.InferenceServerClient(h.http_url) as c:
                c.update_trace_settings(settings={
                    "trace_level": ["TIMESTAMPS"], "trace_rate": ["1"],
                    "trace_file": [str(tmp_path / "trace.jsonl")]})
                a = np.arange(16, dtype=np.int32).reshape(1, 16)
                ins = []
                for name in ("INPUT0", "INPUT1"):
                    i = thttp.InferInput(name, [1, 16], "INT32")
                    i.set_data_from_numpy(a)
                    ins.append(i)
                for k in range(n):
                    c.infer("simple", ins, request_id=f"otlp-{k}")
                c.update_trace_settings(settings={"trace_level": ["OFF"]})
            assert exporter.flush(10)
            assert h.core.tracer.otlp.flush(10)
            text = urllib.request.urlopen(
                f"http://{h.http_url}/metrics").read().decode()
            counters = h.core.tracer.otlp.counters()
        finally:
            tel.disable_otlp()
    spans = collector.spans()
    roots = [s for s in spans if s["kind"] == totlp.SPAN_KIND_SERVER]
    clients = {s["spanId"]: s for s in spans
               if s["kind"] == totlp.SPAN_KIND_CLIENT}
    ours = [r for r in roots if any(
        a["key"] == "triton.request_id"
        and a["value"]["stringValue"].startswith("otlp-")
        for a in r["attributes"])]
    assert len(ours) == n
    for root in ours:
        parent = clients[root["parentSpanId"]]
        assert parent["traceId"] == root["traceId"]
        assert {"key": "replica", "value": {"stringValue": "r1"}} in \
            root["attributes"]
    assert counters["dropped"] == 0 and counters["error"] == 0
    server_posts = sum(
        1 for _p, body in collector.bodies
        if body["resourceSpans"][0]["resource"]["attributes"][0]["value"]
        == {"stringValue": "triton-tpu-server"})
    assert counters["ok"] == server_posts
    assert f'nv_otlp_export_total{{outcome="ok"}} {server_posts}' in text
    assert "nv_otlp_dropped_total 0" in text
