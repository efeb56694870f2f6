"""The port's client telemetry (``triton_client_tpu_torch/_telemetry``) and
its use in the HTTP and gRPC clients, mirroring
``tests/test_client_telemetry.py`` of the JAX package, on the CPU.

* the latency histogram gives the reference's quantiles on the same
  samples, bucket for bucket, and numpy's within 6%;
* the trace context: a header-safe request id is kept, another is
  replaced by a minted one, both packages alike; inside a journey every
  attempt shares the trace id and takes a span id of its own;
* both clients count each request (success, failure, bytes, latency) per
  (model, protocol, method), the Prometheus rendering has the
  observations, the request hook sees each one and a broken hook fails
  nothing; the shared-memory register and transfer counters move;
* end to end: the request id and the traceparent a client sends are the
  ones the port's server records and echoes, over both protocols, and a
  retried request's attempts reach the server on one trace id;
* ``infer_many`` over both protocols: its results equal N ``infer``
  calls, the registry counts N requests, and a failure in the middle of
  the flight is retried from the request that failed;
* ``start_stream(stream_timeout=S)`` ends the stream with
  DEADLINE_EXCEEDED after S seconds, as the reference's gRPC client's
  does against the reference server;
* ``perf_analyzer --export-metrics`` writes strict JSON with the client
  registry's snapshot.
"""

import json
import math
import queue
import threading
import time

import numpy as np
import pytest

import triton_client_tpu.grpc as jgrpc
from triton_client_tpu import _telemetry as jtel
from triton_client_tpu.models import zoo as jzoo
from triton_client_tpu.server import ModelRegistry as JaxRegistry
from triton_client_tpu.server.testing import ServerHarness as JaxHarness
from triton_client_tpu_torch import _telemetry as ttel
from triton_client_tpu_torch import grpc as tgrpc
from triton_client_tpu_torch import http as thttp
from triton_client_tpu_torch import perf_analyzer as tpa
from triton_client_tpu_torch._resilience import RetryPolicy
from triton_client_tpu_torch.models import zoo as tzoo
from triton_client_tpu_torch.server.chaos import ChaosFault, ChaosInjector
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import ServerHarness
from triton_client_tpu_torch.utils import InferenceServerException
from triton_client_tpu_torch.utils import shared_memory as tshm

tel = ttel.telemetry


@pytest.fixture(scope="module")
def server():
    registry = ModelRegistry()
    registry.register_model(tzoo.make_simple())
    with ServerHarness(registry) as h:
        yield h


@pytest.fixture(autouse=True)
def _fresh_registry():
    tel().reset()
    yield
    tel().reset()
    tel().set_request_hook(None)


def _simple_inputs(mod, a=None):
    a = np.arange(16, dtype=np.int32).reshape(1, 16) if a is None else a
    inputs = [mod.InferInput("INPUT0", [1, 16], "INT32"),
              mod.InferInput("INPUT1", [1, 16], "INT32")]
    inputs[0].set_data_from_numpy(a)
    inputs[1].set_data_from_numpy(np.ones_like(a))
    return inputs


def _rows():
    return {(s["protocol"], s["method"], s["model"]): s
            for s in tel().snapshot()["requests"]}


# -- the histogram -----------------------------------------------------------

@pytest.mark.parametrize("dist", ["uniform", "lognormal", "bimodal"])
def test_histogram_quantiles_equal_reference(dist):
    rng = np.random.default_rng(42)
    n = 20000
    if dist == "uniform":
        samples = rng.uniform(1e-3, 1e-2, n)
    elif dist == "lognormal":
        samples = np.exp(rng.normal(np.log(5e-3), 0.5, n))
    else:
        samples = np.concatenate([
            rng.normal(2e-3, 1e-4, int(n * 0.4)),
            rng.normal(50e-3, 2e-3, n - int(n * 0.4))]).clip(min=1e-5)
    h, ref = ttel.LatencyHistogram(), jtel.LatencyHistogram()
    for v in samples:
        h.observe(float(v))
        ref.observe(float(v))
    assert h.count == n and h.sum_s == pytest.approx(samples.sum(),
                                                     rel=1e-9)
    for p in (50, 90, 99):
        assert h.percentile(p) == ref.percentile(p)
        assert h.percentile(p) == pytest.approx(
            float(np.percentile(samples, p)), rel=0.06)
    assert h.snapshot_us() == ref.snapshot_us()


def test_histogram_empty_extremes_and_merge():
    h = ttel.LatencyHistogram()
    assert math.isnan(h.quantile(0.5))
    assert h.snapshot_us() == jtel.LatencyHistogram().snapshot_us()
    h.observe(0.0)
    h.observe(1e9)
    assert h.quantile(0.0) < 1e-6 and h.quantile(1.0) > 100.0
    a, b = ttel.LatencyHistogram(), ttel.LatencyHistogram()
    for v in (1e-3, 2e-3):
        a.observe(v)
    for v in (4e-3, 8e-3):
        b.observe(v)
    a.merge(b)
    assert a.count == 4 and a.sum_s == pytest.approx(15e-3)


# -- the trace context -------------------------------------------------------

@pytest.mark.parametrize("rid", ["my-id", "café-1", "id\nwith\nnewlines",
                                 "tab\tid", ""])
def test_trace_context_keeps_what_the_reference_keeps(rid):
    ctx, ref = ttel.new_trace_context(rid), jtel.new_trace_context(rid)
    kept = ctx["triton-request-id"] == rid
    assert kept == (ref["triton-request-id"] == rid)
    if not kept:
        assert len(ctx["triton-request-id"]) == 16
    version, trace_id, span_id, flags = ctx["traceparent"].split("-")
    assert (version, flags) == ("00", "01")
    assert len(trace_id) == 32 and len(span_id) == 16
    assert ctx != ttel.new_trace_context(rid)


def test_journey_shares_one_trace_id_across_attempts():
    scope = ttel.begin_journey("j-1")
    try:
        assert ttel.begin_journey() is None  # never nested
        a = ttel.new_trace_context()
        b = ttel.new_trace_context()
        journey = ttel.current_journey()
    finally:
        ttel.end_journey(scope)
    assert ttel.current_journey() is None
    ta, tb = a["traceparent"].split("-"), b["traceparent"].split("-")
    assert ta[1] == tb[1] == journey.trace_id and ta[2] != tb[2]
    assert a["triton-request-id"] == b["triton-request-id"] == "j-1"
    assert journey.traceparent == b["traceparent"]
    extra, rid = ttel.merge_trace_headers({"TraceParent": "x"}, "r")
    assert "traceparent" not in extra and rid == "r"
    assert ttel.traceparent_on_wire({"TraceParent": "x"}, extra) == "x"


# -- counters ----------------------------------------------------------------

@pytest.mark.parametrize("mod,protocol", [(thttp, "http"), (tgrpc, "grpc")])
def test_each_client_counts_its_requests(server, mod, protocol):
    with mod.InferenceServerClient(server.http_url) as c:
        c.infer("simple", _simple_inputs(mod))
        c.async_infer("simple", _simple_inputs(mod)).get_result()
    rows = _rows()
    for method in ("infer", "async_infer"):
        s = rows[(protocol, method, "simple")]
        assert s["success"] == 1 and s["failure"] == 0
        assert s["request_bytes"] > 0 and s["response_bytes"] > 0
        assert s["count"] == 1 and s["p50_us"] > 0


@pytest.mark.parametrize("mod,protocol", [(thttp, "http"), (tgrpc, "grpc")])
def test_failures_are_counted(server, mod, protocol):
    with mod.InferenceServerClient(server.http_url) as c:
        with pytest.raises(InferenceServerException):
            c.infer("no_such_model", _simple_inputs(mod))
    s = _rows()[(protocol, "infer", "no_such_model")]
    assert (s["success"], s["failure"]) == (0, 1)


def test_prometheus_rendering_has_the_observations(server):
    with thttp.InferenceServerClient(server.http_url) as c:
        c.infer("simple", _simple_inputs(thttp))
    text = tel().render_prometheus()
    assert ('nv_client_inference_request_success{model="simple",'
            'protocol="http",method="infer"} 1') in text
    assert 'quantile="0.99"' in text
    assert "nv_client_inference_request_duration_us_count" in text


def test_request_hook_and_a_broken_one(server):
    events = []
    tel().set_request_hook(events.append)
    with thttp.InferenceServerClient(server.http_url) as c:
        c.infer("simple", _simple_inputs(thttp), request_id="hooked")
        assert len(events) == 1
        ev = events[0]
        assert (ev["model"], ev["protocol"], ev["ok"], ev["request_id"]) \
            == ("simple", "http", True, "hooked")
        assert ev["latency_s"] > 0
        tel().set_request_hook(
            lambda ev: (_ for _ in ()).throw(RuntimeError("boom")))
        res = c.infer("simple", _simple_inputs(thttp))
    assert res.as_numpy("OUTPUT0") is not None


def test_shared_memory_counters(server):
    h = tshm.create_shared_memory_region("tele_tx", "/tele_tx", 64)
    try:
        tshm.set_shared_memory_region(h, [np.zeros(16, np.float32)])
        for mod, protocol in ((thttp, "http"), (tgrpc, "grpc")):
            with mod.InferenceServerClient(server.http_url) as c:
                c.register_system_shared_memory("tele_tx", "/tele_tx", 64)
                c.unregister_system_shared_memory("tele_tx")
    finally:
        tshm.destroy_shared_memory_region(h)
    snap = tel().snapshot()["shared_memory"]
    assert snap["transfer"] == [{"kind": "system", "direction": "write",
                                 "transfers": 1, "bytes": 64}]
    assert {(r["protocol"], r["kind"], r["registrations"], r["bytes"])
            for r in snap["register"]} == {("http", "system", 1, 64),
                                           ("grpc", "system", 1, 64)}
    assert "nv_client_shared_memory_transfer_bytes_total" in \
        tel().render_prometheus()


# -- end to end --------------------------------------------------------------

@pytest.fixture
def traced(server, tmp_path):
    tf = tmp_path / "trace.jsonl"
    with thttp.InferenceServerClient(server.http_url) as c:
        c.update_trace_settings(settings={
            "trace_file": [str(tf)], "trace_level": ["TIMESTAMPS"],
            "trace_rate": ["1"]})
    yield tf
    with thttp.InferenceServerClient(server.http_url) as c:
        c.update_trace_settings(settings={"trace_level": ["OFF"]})


def _records(tf, n=1):
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if tf.exists():
            out = [json.loads(x) for x in open(tf) if x.strip()]
            if len(out) >= n:
                return out
        time.sleep(0.02)
    raise AssertionError("no trace records")


@pytest.mark.parametrize("mod,protocol", [(thttp, "http"), (tgrpc, "grpc")])
def test_client_and_server_join_on_the_ids_sent(server, traced, tmp_path,
                                                mod, protocol):
    spans = tmp_path / "client.jsonl"
    tel().enable_tracing(str(spans))
    try:
        with mod.InferenceServerClient(server.http_url) as c:
            c.infer("simple", _simple_inputs(mod), request_id="corr-1")
            c.infer("simple", _simple_inputs(mod))
    finally:
        tel().disable_tracing()
    client = [json.loads(x) for x in open(spans)]
    records = _records(traced, 2)
    assert len(client) == 2
    for crec in client:
        srec = next(r for r in records
                    if r.get("triton_request_id") == crec["request_id"])
        assert srec["traceparent"] == crec["traceparent"]
        assert [s["name"] for s in crec["spans"]] == \
            ["REQUEST", "SERIALIZE", "NETWORK", "DESERIALIZE"]
        assert crec["protocol"] == protocol and crec["ok"]
    assert client[0]["request_id"] == "corr-1"
    assert len(client[1]["request_id"]) == 16


class _NthFault(ChaosInjector):
    """A 503 on the ``n``-th request this injector sees (1-based)."""

    def __init__(self, n):
        super().__init__(rate=0.0)
        self.n, self.seen = n, 0

    def decide(self, model_name):
        self.seen += 1
        return ChaosFault("error", status=503) if self.seen == self.n \
            else None


def test_a_retried_request_is_one_journey(server, traced, tmp_path):
    spans = tmp_path / "client.jsonl"
    policy = RetryPolicy(max_attempts=3, retry_infer=True,
                         initial_backoff_s=0.01, seed=1)
    server.core.chaos = _NthFault(1)
    tel().enable_tracing(str(spans))
    try:
        with thttp.InferenceServerClient(server.http_url) as c:
            c.infer("simple", _simple_inputs(thttp), request_id="j",
                    retry_policy=policy)
    finally:
        tel().disable_tracing()
        server.core.chaos = None
    client = [json.loads(x) for x in open(spans)]
    names = [r["spans"][0]["name"] for r in client]
    assert names == ["REQUEST", "RETRY", "REQUEST"]
    assert [r.get("attempt") for r in client] == [1, 1, 2]
    trace_ids = {r["traceparent"].split("-")[1] for r in client}
    assert len(trace_ids) == 1
    assert [r["ok"] for r in client] == [False, False, True]
    ours = [r for r in _records(traced, 2)
            if r.get("triton_request_id") == "j"]
    assert {r["traceparent"].split("-")[1] for r in ours} == trace_ids
    assert len({r["traceparent"] for r in ours}) == 2
    assert _rows()[("http", "infer", "simple")]["retries"] == 1


# -- infer_many --------------------------------------------------------------

def _items(mod, n, seed):
    """(the INPUT0 arrays, the requests): OUTPUT0 is INPUT0 + 1."""
    rng = np.random.default_rng(seed)
    arrays = [rng.integers(-50, 50, (1, 16)).astype(np.int32)
              for _ in range(n)]
    return arrays, [_simple_inputs(mod, a) for a in arrays]


@pytest.mark.parametrize("mod,protocol", [(thttp, "http"), (tgrpc, "grpc")])
def test_infer_many_equals_n_infer_calls(server, mod, protocol):
    arrays, items = _items(mod, 5, 3)
    with mod.InferenceServerClient(server.http_url) as c:
        many = c.infer_many("simple", items,
                            request_ids=[f"m{i}" for i in range(5)])
        tel().reset()
        single = [c.infer("simple", item) for item in items]
    tel().reset()
    with mod.InferenceServerClient(server.http_url) as c:
        c.infer_many("simple", items)
    assert len(many) == 5
    for x, a, b in zip(arrays, many, single):
        for out in ("OUTPUT0", "OUTPUT1"):
            np.testing.assert_array_equal(a.as_numpy(out), b.as_numpy(out))
        np.testing.assert_array_equal(a.as_numpy("OUTPUT0"), x + 1)
    s = _rows()[(protocol, "infer", "simple")]
    assert (s["success"], s["failure"], s["count"]) == (5, 0, 5)
    with mod.InferenceServerClient(server.http_url) as c:
        assert c.infer_many("simple", []) == []
        with pytest.raises(InferenceServerException,
                           match="request_ids length"):
            c.infer_many("simple", items, request_ids=["a"])
        bad = _simple_inputs(mod)
        bad[0] = mod.InferInput("OTHER", [1, 16], "INT32")
        bad[0].set_data_from_numpy(np.zeros((1, 16), np.int32))
        with pytest.raises(InferenceServerException, match="template"):
            c.infer_many("simple", [items[0], bad])


@pytest.mark.parametrize("mod,protocol", [(thttp, "http"), (tgrpc, "grpc")])
def test_infer_many_retries_from_the_request_that_failed(server, mod,
                                                         protocol):
    """A 503 on the third request of five: the retry sends the third to
    fifth again, not the first two; five results, in order."""
    arrays, items = _items(mod, 5, 4)
    policy = RetryPolicy(max_attempts=3, retry_infer=True,
                         initial_backoff_s=0.01, seed=2)
    server.core.chaos = fault = _NthFault(3)
    try:
        with mod.InferenceServerClient(server.http_url) as c:
            results = c.infer_many("simple", items, retry_policy=policy)
    finally:
        server.core.chaos = None
    assert fault.seen == 6  # five requests and the one sent again
    for x, res in zip(arrays, results):
        np.testing.assert_array_equal(res.as_numpy("OUTPUT0"), x + 1)
    s = _rows()[(protocol, "infer", "simple")]
    assert (s["success"], s["failure"], s["retries"]) == (5, 1, 1)


# -- stream_timeout ----------------------------------------------------------

def _stream_errors(client_mod, url, timeout_s):
    """The answers a stream with ``stream_timeout`` gets: one request
    answered, then the deadline's error."""
    got = queue.Queue()
    with client_mod.InferenceServerClient(url) as c:
        c.start_stream(lambda result, error: got.put((result, error)),
                       stream_timeout=timeout_s)
        c.async_stream_infer("simple", _simple_inputs(client_mod))
        first = got.get(timeout=30)
        t0 = time.monotonic()
        second = got.get(timeout=30)
        waited = time.monotonic() - t0
        c.stop_stream()
    return first, second, waited


def test_stream_timeout_ends_the_stream_as_the_reference(server):
    jreg = JaxRegistry()
    jreg.register_model(jzoo.make_simple())
    with JaxHarness(jreg) as jh:
        ref = _stream_errors(jgrpc, jh.grpc_url, 1.5)
    port = _stream_errors(tgrpc, server.http_url, 1.5)
    for first, second, waited in (port, ref):
        assert first[1] is None and first[0].as_numpy("OUTPUT0") is not None
        assert second[0] is None
        assert waited < 5.0
    assert port[1][1].status() == ref[1][1].status() == \
        "StatusCode.DEADLINE_EXCEEDED"
    assert port[1][1].message() == ref[1][1].message()
    with tgrpc.InferenceServerClient(server.http_url) as c:
        c.start_stream(lambda result, error: None, stream_timeout=0.2)
        time.sleep(0.5)
        with pytest.raises(InferenceServerException,
                           match="no longer in valid state"):
            c.async_stream_infer("simple", _simple_inputs(tgrpc))
        c.stop_stream()
    s = _rows()[("grpc", "stream_infer", "simple")]
    assert s["success"] == 1 and s["count"] == 0  # counted, not observed


# -- perf_analyzer --export-metrics ------------------------------------------

def test_export_metrics_writes_strict_json(server, tmp_path, capsys):
    path = tmp_path / "m.json"
    assert tpa.main(["-m", "simple", "-u", server.http_url,
                     "--concurrency-range", "1:2", "--measurement-interval",
                     "300", "--export-metrics", str(path)]) == 0
    capsys.readouterr()

    def strict(token):
        raise ValueError(f"not strict JSON: {token}")

    data = json.loads(path.read_text(), parse_constant=strict)
    assert data["model"] == "simple" and data["load_mode"] == "closed_loop"
    assert [r["concurrency"] for r in data["results"]] == [1, 2]
    rows = {(r["protocol"], r["method"]): r
            for r in data["client_telemetry"]["requests"]}
    assert rows[("http", "infer")]["success"] > 0
    # the reference's snapshot keys, the cluster client's included
    assert set(data["client_telemetry"]) == set(
        jtel.ClientTelemetry().snapshot())
