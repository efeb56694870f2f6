"""The retry layer, deadlines, chaos and drain of the port
(``triton_client_tpu_torch/_resilience.py``, ``server/chaos.py``, the
core's deadline gates and ``InferenceCore.drain``) against the JAX
package's, on the CPU.

* ``RetryPolicy``: the same decisions as the reference's on the same
  failures (statuses, oversize and quarantine texts, attempts, methods),
  the same seeded backoff, the server's pushback honoured; the port's own
  connection failures (``http.client``, sockets, a gRPC-Web
  UNAVAILABLE) classify as the reference's urllib3 and grpc ones do;
  ``call_with_retry`` recovers, keeps to its deadline and counts only the
  retries it commits;
* chaos: the same seed draws the same faults as the reference's; rate,
  model filter, cap and transient window; the kinds the port has no
  machinery for are refused by name;
* deadlines: ``timeout`` consumed and the header winning as in the
  reference; a request past its deadline gets the same 504 from both
  servers over HTTP and gRPC, with no COMPUTE span, counted in
  ``nv_inference_deadline_exceeded_total``; one that expires while queued
  in the batcher is dropped before any compute;
* sheds: a full queue answers both servers' 429 with the same text and
  ``Retry-After`` / ``triton-retry-after-ms``; on a gRPC stream in band;
* the clients: a retry after an injected error or a connection aborted in
  the middle of its response succeeds and is counted; each attempt
  carries the remaining deadline anew (``triton-timeout-us`` on HTTP, the
  ``timeout`` parameter on gRPC); a 413 is sent once;
* drain: in-flight requests finish, new ones get 503 with pushback, and
  the CLI server exits 0 on SIGTERM within ``--drain-timeout``;
* ``perf_analyzer --priority/--tenant`` classes and ``--retries``.
"""

import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import triton_client_tpu._resilience as jres
import triton_client_tpu.grpc as jgrpc
from triton_client_tpu.models import zoo as jzoo
from triton_client_tpu.server import chaos as jchaos
from triton_client_tpu.server import types as jtypes
from triton_client_tpu.server.registry import ModelRegistry as JaxRegistry
from triton_client_tpu.server.testing import ServerHarness as JaxHarness
from triton_client_tpu.utils import \
    InferenceServerException as JaxServerException
from triton_client_tpu_torch import _resilience as tres
from triton_client_tpu_torch import grpc as tgrpc
from triton_client_tpu_torch import http as thttp
from triton_client_tpu_torch import perf_analyzer as tpa
from triton_client_tpu_torch._telemetry import telemetry
from triton_client_tpu_torch.models import zoo as tzoo
from triton_client_tpu_torch.protocol import inference as pb
from triton_client_tpu_torch.protocol.grpc_web import iter_frames, trailers
from triton_client_tpu_torch.protocol.service import StatusCode
from triton_client_tpu_torch.server import chaos as tchaos
from triton_client_tpu_torch.server import types as ttypes
from triton_client_tpu_torch.server.core import InferenceCore
from triton_client_tpu_torch.server.model import PyModel, make_config
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import ServerHarness, free_port
from triton_client_tpu_torch.server.types import (InferError, InferRequest,
                                                  InputTensor)
from triton_client_tpu_torch.utils import InferenceServerException

MODEL = "custom_identity_int32"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _retries_for(model, protocol=None):
    return sum(r["retries"] for r in telemetry().snapshot()["requests"]
               if r["model"] == model
               and (protocol is None or r["protocol"] == protocol))


# -- RetryPolicy -----------------------------------------------------------------

_FAILURES = [
    ("429", "request queue is full; retry later"),
    ("503", "server busy"),
    ("StatusCode.UNAVAILABLE", "x"),
    ("StatusCode.RESOURCE_EXHAUSTED", "request queue is full; retry later"),
    ("400", "bad"), ("404", "no model"), ("500", "boom"),
    ("StatusCode.DEADLINE_EXCEEDED", "late"),
    ("StatusCode.INVALID_ARGUMENT", "x"),
    ("413", "request of 131072 bytes exceeds the server's max request "
            "size of 65536 bytes (--max-request-bytes)"),
    ("StatusCode.RESOURCE_EXHAUSTED",
     "Received message larger than max (131192 vs. 65536)"),
    ("429", "request of 98304 bytes to model 'm' exceeds the server's "
            "memory budget for tier 3; retry later"),
    ("503", "model 'm' is quarantined after repeated device faults; "
            "retry on another replica"),
    ("StatusCode.UNAVAILABLE", "model 'm' is quarantined"),
    ("500", "model 'm' is quarantined"),
]


@pytest.mark.parametrize("status,msg", _FAILURES)
def test_retry_decisions_equal(status, msg):
    for kw in ({}, {"retry_infer": True}, {"max_attempts": 2},
               {"retry_infer": True, "retryable_statuses": {"413", "429"}}):
        for method in ("infer", "health", "metadata"):
            for attempt in (1, 2, 3):
                want = jres.RetryPolicy(**kw).should_retry(
                    JaxServerException(msg, status=status), method, attempt)
                got = tres.RetryPolicy(**kw).should_retry(
                    InferenceServerException(msg, status=status), method,
                    attempt)
                assert got == want, (kw, method, attempt)
    for name in ("is_oversize_error", "is_quarantine_error",
                 "normalized_status"):
        assert getattr(tres, name)(InferenceServerException(
            msg, status=status)) == getattr(jres, name)(
            JaxServerException(msg, status=status)), name


def test_governor_413_over_grpc_reads_as_oversize():
    """The memory governor's permanent verdict, which gRPC carries as
    RESOURCE_EXHAUSTED, is never retried by the port's clients."""
    e = InferenceServerException(
        "request of 262144 bytes to model 'm' exceeds the tier-0 share of "
        "the server's memory budget (--mem-budget-bytes) and can never be "
        "admitted; reduce the payload or use shared memory",
        status="StatusCode.RESOURCE_EXHAUSTED")
    assert tres.is_oversize_error(e)
    assert not tres.RetryPolicy(retry_infer=True).should_retry(
        e, "infer", 1)


@pytest.mark.parametrize("exc", [
    ConnectionResetError(), ConnectionRefusedError(), BrokenPipeError(),
    http.client.RemoteDisconnected("closed"),
    http.client.IncompleteRead(b"{", 63),
    http.client.BadStatusLine("junk")])
def test_connection_failures_are_connection_errors(exc):
    assert tres.is_connection_error(exc)
    assert tres.RetryPolicy(retry_infer=True).should_retry(exc, "infer", 1)


def test_other_failures_are_not_connection_errors():
    assert not tres.is_connection_error(ValueError("nope"))
    assert tres.is_timeout_error(TimeoutError())
    # the port's gRPC client reports a broken connection as UNAVAILABLE
    e = InferenceServerException("failed to connect: [Errno 104]",
                                 status="StatusCode.UNAVAILABLE")
    assert tres.RetryPolicy(retry_infer=True).should_retry(e, "infer", 1)


def test_backoff_equal_seeded_and_pushback_wins():
    kw = dict(initial_backoff_s=0.1, backoff_multiplier=2.0,
              max_backoff_s=0.5, seed=42)
    a, b = tres.RetryPolicy(**kw), jres.RetryPolicy(**kw)
    got = [a.backoff_s(n) for n in range(1, 8)]
    assert got == [b.backoff_s(n) for n in range(1, 8)]
    for n, d in enumerate(got, 1):
        assert 0.0 <= d <= min(0.5, 0.1 * 2.0 ** (n - 1))
    assert tres.RetryPolicy(initial_backoff_s=10.0).backoff_s(
        1, retry_after_s=0.125) == 0.125


def test_helpers_equal():
    for a, b in ((None, None), (5.0, None), (None, 2.0), (5.0, 2.0)):
        assert tres.min_timeout(a, b) == jres.min_timeout(a, b)
    for s in (0.0, 1e-7, 0.5, 12.25):
        assert tres.remaining_us(s) == jres.remaining_us(s)
    e = tres.deadline_exceeded_error()
    assert e.status() == "StatusCode.DEADLINE_EXCEEDED"
    assert str(e) == str(jres.deadline_exceeded_error())
    with pytest.raises(ValueError):
        tres.RetryPolicy(max_attempts=0)


def test_call_with_retry_recovers_deadline_and_counting():
    p = tres.RetryPolicy(max_attempts=3, retry_infer=True,
                         initial_backoff_s=0.001, seed=0)
    attempts = []

    def fn(remaining, attempt):
        attempts.append((attempt, remaining))
        if attempt < 3:
            raise InferenceServerException("overloaded", status="503")
        return "ok"

    before = _retries_for("cwr-m")
    assert tres.call_with_retry(p, fn, deadline_s=30.0,
                                retry_meta=("cwr-m", "http", "infer",
                                            "")) == "ok"
    assert [a for a, _ in attempts] == [1, 2, 3]
    rem = [r for _, r in attempts]
    assert rem[0] > rem[1] > rem[2] > 0  # each attempt's remaining budget
    assert _retries_for("cwr-m") == before + 2

    def always_503(remaining, attempt):
        raise InferenceServerException("overloaded", status="503")

    t0 = time.monotonic()
    with pytest.raises(InferenceServerException):
        tres.call_with_retry(tres.RetryPolicy(
            max_attempts=50, retry_infer=True, initial_backoff_s=0.02,
            seed=0), always_503, deadline_s=0.15)
    assert time.monotonic() - t0 < 1.0

    def pushback_far(remaining, attempt):
        e = InferenceServerException("overloaded", status="503")
        e.retry_after_s = 10.0
        raise e

    with pytest.raises(InferenceServerException):
        tres.call_with_retry(p, pushback_far, deadline_s=0.05,
                             retry_meta=("abandon-m", "http", "infer", ""))
    assert _retries_for("abandon-m") == 0

    def timeout(remaining, attempt):
        time.sleep(remaining)
        raise TimeoutError("timed out")

    with pytest.raises(InferenceServerException) as ei:
        tres.call_with_retry(p, timeout, deadline_s=0.05)
    assert ei.value.status() == "StatusCode.DEADLINE_EXCEEDED"


# -- chaos ---------------------------------------------------------------------

@pytest.mark.parametrize("kinds", [("error",), ("error", "latency"),
                                   ("error", "latency", "abort"),
                                   ("abort", "mem_pressure", "latency")])
@pytest.mark.parametrize("seed", [0, 7, 42])
def test_same_seed_same_faults_as_reference(kinds, seed):
    def draws(mod):
        inj = mod.ChaosInjector(rate=0.3, kinds=kinds, seed=seed,
                                latency_ms=25.0)
        out = []
        for i in range(300):
            f = inj.decide("ab"[i % 2])
            out.append(None if f is None else (f.kind, f.latency_s,
                                               f.status))
        return out, inj.counters(), inj.injected_total

    assert draws(tchaos) == draws(jchaos)


def test_injector_rate_filter_cap_and_transient():
    assert tchaos.ChaosInjector(rate=0.0).decide("m") is None
    inj = tchaos.ChaosInjector(rate=1.0, models=["a"])
    assert inj.decide("b") is None and inj.decide("a") is not None
    inj = tchaos.ChaosInjector(rate=1.0, max_faults=2)
    assert sum(inj.decide("m") is not None for _ in range(5)) == 2
    assert inj.counters() == {"m": 2}
    assert inj.kind_counters() == {("m", "error"): 2}
    inj = tchaos.ChaosInjector(rate=1.0, transient_s=60.0)
    assert inj.decide("m") is not None
    assert all(inj.decide("m") is None for _ in range(20))


def test_build_injector_validates_and_refuses_unported_kinds():
    for mod in (tchaos, jchaos):
        with pytest.raises(ValueError):
            mod.build_injector(1.5)
        with pytest.raises(ValueError):
            mod.build_injector(0.5, kinds_csv="explode")
        assert mod.build_injector(0.5, kinds_csv="latency, error",
                                  seed=3).kinds == ("latency", "error")
    # worker_kill is ported: accepted by both, drawn per request alike
    t, j = (mod.build_injector(0.5, kinds_csv="error,worker_kill", seed=3)
            for mod in (tchaos, jchaos))
    assert t.kinds == j.kinds == ("error", "worker_kill")
    seq = [[getattr(inj.decide("m"), "kind", None) for _ in range(40)]
           for inj in (t, j)]
    assert seq[0] == seq[1] and "worker_kill" in seq[0]
    # and a junk kind is refused with the reference's text
    texts = []
    for mod in (tchaos, jchaos):
        with pytest.raises(ValueError) as e:
            mod.build_injector(0.5, kinds_csv="explode")
        texts.append(str(e.value))
    assert texts[0] == texts[1]
    # device_error and load_fail are ported: accepted by both, never drawn
    # per request
    for kind in ("device_error", "load_fail"):
        for mod in (tchaos, jchaos):
            inj = mod.build_injector(1.0, kinds_csv=f"error,{kind}", seed=3)
            assert inj.kinds == ("error", kind)
            assert all(inj.decide("m").kind == "error" for _ in range(20))


def test_chaos_abort_is_503_infer_error():
    e = tchaos.ChaosAbort()
    assert isinstance(e, InferError) and e.http_status == 503
    assert str(e) == str(jchaos.ChaosAbort())


# -- deadlines -----------------------------------------------------------------

@pytest.mark.parametrize("params,header", [
    ({"timeout": 50_000, "keep": 1}, None), ({"timeout": 10}, "60000000"),
    ({"timeout": "soon"}, None), ({}, "junk"), ({"timeout": 0}, None),
    ({"timeout": -5}, None), ({}, None)])
def test_apply_request_deadline_equal(params, header):
    def run(types):
        req = types.InferRequest(model_name="m", parameters=dict(params))
        t0 = time.monotonic_ns()
        try:
            types.apply_request_deadline(req, header_us=header)
        except types.InferError as e:
            return ("InferError", str(e), e.http_status)
        left = (req.deadline_ns - t0) // 10**7 if req.deadline_ns else 0
        return left, req.parameters

    assert run(ttypes) == run(jtypes)


@pytest.fixture(scope="module")
def servers():
    regs = []
    for reg, zoo in ((JaxRegistry(), jzoo), (ModelRegistry(), tzoo)):
        reg.register_model(zoo.make_custom_identity_int32())
        reg.register_model(zoo.make_simple())
        regs.append(reg)
    with JaxHarness(regs[0]) as jh, ServerHarness(regs[1]) as th:
        yield {"jax": jh, "port": th}


@pytest.fixture(autouse=True)
def _clean(request):
    hs = request.node.funcargs.get("servers")
    yield
    if hs is None:
        return
    for h in hs.values():
        stats = h.core.registry.get(MODEL).stats
        end = time.monotonic() + 10
        while stats.pending_count and time.monotonic() < end:
            time.sleep(0.01)
        h.core.chaos = None
        h.core.queue_limits.clear()
        h.core.accepting = True
        h.core.trace_settings["trace_level"] = ["OFF"]


def _x(n=4):
    return np.arange(n, dtype=np.int32).reshape(1, n)


def _inputs(mod, x=None):
    x = _x() if x is None else x
    i = mod.InferInput("INPUT0", list(x.shape), "INT32")
    i.set_data_from_numpy(x)
    return [i]


def _client(pkg, protocol, h):
    if protocol == "grpc":
        if pkg == "jax":
            return jgrpc, jgrpc.InferenceServerClient(h.grpc_url)
        return tgrpc, tgrpc.InferenceServerClient(h.http_url)
    return thttp, thttp.InferenceServerClient(h.http_url)


def _err(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - either package's exception
        return e
    raise AssertionError("no error")


@pytest.mark.parametrize("protocol", ["http", "grpc"])
def test_expired_request_504_equal_no_compute(servers, protocol, tmp_path):
    out = {}
    for pkg, h in servers.items():
        path = str(tmp_path / f"{pkg}.json")
        h.core.trace_settings.update({"trace_file": [path],
                                      "trace_level": ["TIMESTAMPS"],
                                      "trace_rate": ["1"]})
        h.core.tracer.settings_updated()
        mod, c = _client(pkg, protocol, h)
        before = dict(h.core.deadline_exceeded_by_model)
        e = _err(lambda: c.infer(MODEL, _inputs(mod), timeout=1))
        c.close()
        h.core.trace_settings["trace_level"] = ["OFF"]
        end = time.monotonic() + 10
        while not (os.path.exists(path) and open(path).read()):
            assert time.monotonic() < end
            time.sleep(0.01)
        spans = [s["name"] for s in json.loads(
            open(path).read().splitlines()[-1])["spans"]]
        out[pkg] = (e.status(), e.message(),
                    h.core.deadline_exceeded_by_model.get(MODEL, 0)
                    - before.get(MODEL, 0), "COMPUTE" in spans)
    assert out["port"] == out["jax"]
    assert out["port"][2:] == (1, False)
    assert "exceeded its deadline before execution" in out["port"][1]
    text = urllib.request.urlopen(
        f"http://{servers['port'].http_url}/metrics").read().decode()
    assert 'nv_inference_deadline_exceeded_total{model="%s"}' % MODEL in text


def test_item_expired_in_the_batcher_queue_is_dropped():
    """A batched request whose deadline passes while it waits in the
    batcher's queue fails with 504 and never reaches the model."""
    release = threading.Event()
    seen = []
    cfg = make_config("slow_batched", inputs=[("IN", "INT32", [1])],
                      outputs=[("OUT", "INT32", [1])], max_batch_size=1,
                      preferred_batch_sizes=[1], instance_kind="KIND_CPU")

    def fn(inputs, params):
        seen.append(int(inputs["IN"][0, 0]))
        release.wait(timeout=20)
        return {"OUT": inputs["IN"]}

    registry = ModelRegistry()
    registry.register_model(PyModel(cfg, fn))
    core = InferenceCore(registry)
    results = {}

    def send(i, timeout_us):
        req = InferRequest(model_name="slow_batched", inputs=[InputTensor(
            "IN", "INT32", (1, 1), data=np.array([[i]], np.int32))],
            parameters={"timeout": timeout_us})
        ttypes.apply_request_deadline(req)
        try:
            results[i] = core.infer(req)
        except InferError as e:
            results[i] = e

    try:
        # 4 execute (MAX_INFLIGHT, blocked), then one with a short deadline
        busy = [threading.Thread(target=send, args=(i, 0)) for i in range(4)]
        for t in busy:
            t.start()
        end = time.monotonic() + 10
        while len(seen) < 4:
            assert time.monotonic() < end
            time.sleep(0.005)
        late = threading.Thread(target=send, args=(99, 50_000))
        late.start()
        time.sleep(0.2)  # its 50 ms deadline passes while it queues
        release.set()
        for t in busy + [late]:
            t.join(timeout=30)
        assert isinstance(results[99], InferError)
        assert results[99].http_status == 504
        assert "exceeded its deadline while queued" in str(results[99])
        assert 99 not in seen
        assert core.deadline_exceeded_by_model == {"slow_batched": 1}
    finally:
        release.set()
        core.shutdown()


# -- sheds -------------------------------------------------------------------

def _occupy(h, delay_ms=800):
    def run():
        try:
            with thttp.InferenceServerClient(h.http_url) as c:
                c.infer(MODEL, _inputs(thttp),
                        parameters={"execute_delay_ms": delay_ms})
        except Exception:  # noqa: BLE001 - occupancy is what matters
            pass

    t = threading.Thread(target=run, daemon=True)
    t.start()
    stats = h.core.registry.get(MODEL).stats
    end = time.monotonic() + 10
    while stats.pending_count < 1:
        assert time.monotonic() < end
        time.sleep(0.005)
    return t


def _raw_infer(url):
    body = json.dumps({"inputs": [{"name": "INPUT0", "datatype": "INT32",
                                   "shape": [1, 4],
                                   "data": [0, 1, 2, 3]}]}).encode()
    req = urllib.request.Request(f"http://{url}/v2/models/{MODEL}/infer",
                                 data=body)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, None, {}
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())["error"], {
            k: e.headers.get(k) for k in ("Retry-After",
                                          "triton-retry-after-ms")}


def test_queue_full_429_equal_over_http(servers):
    out = {}
    for pkg, h in servers.items():
        h.core.queue_limits[MODEL] = 1
        t = _occupy(h)
        try:
            out[pkg] = _raw_infer(h.http_url)
        finally:
            t.join(timeout=30)
    assert out["port"] == out["jax"]
    assert out["port"][0] == 429
    # 0.25 s x (1 + 1 pending / bound 1)
    assert out["port"][2] == {"Retry-After": "1",
                              "triton-retry-after-ms": "500"}


def test_queue_full_in_band_on_a_grpc_stream(servers):
    import queue

    errs = {}
    for pkg, h in servers.items():
        h.core.queue_limits[MODEL] = 1
        t = _occupy(h)
        done = queue.Queue()
        mod, c = _client(pkg, "grpc", h)
        try:
            c.start_stream(callback=lambda result, error: done.put(error))
            c.async_stream_infer(MODEL, _inputs(mod))
            errs[pkg] = done.get(timeout=20)
        finally:
            c.stop_stream()
            c.close()
            t.join(timeout=30)
    assert errs["port"].status() == errs["jax"].status() == \
        "StatusCode.RESOURCE_EXHAUSTED"
    assert str(errs["port"]) == str(errs["jax"])
    assert "full" in str(errs["port"])


def test_config_parameter_sets_the_bound():
    cfg = make_config("q", inputs=[("I", "INT32", [-1])],
                      outputs=[("O", "INT32", [-1])],
                      parameters={"max_queue_size": "7"})
    core = InferenceCore(ModelRegistry())
    try:
        m = PyModel(cfg, lambda i, p: i)
        assert core.max_queue_size(m) == 7
        core.queue_limits["q"] = 3
        assert core.max_queue_size(m) == 3
    finally:
        core.shutdown()


# -- the clients: retries after injected faults --------------------------------

POLICY = dict(max_attempts=3, retry_infer=True, initial_backoff_s=0.01)


@pytest.mark.parametrize("protocol,kind", [
    ("http", "error"), ("grpc", "error"), ("http", "abort"),
    ("grpc", "abort")])
def test_retry_after_one_injected_fault(servers, protocol, kind):
    h = servers["port"]
    h.core.chaos = tchaos.ChaosInjector(rate=1.0, kinds=[kind],
                                        max_faults=1, seed=1)
    before = _retries_for(MODEL, protocol)
    mod, c = _client("port", protocol, h)
    x = _x()
    r = c.infer(MODEL, _inputs(mod, x),
                retry_policy=tres.RetryPolicy(**POLICY))
    c.close()
    np.testing.assert_array_equal(r.as_numpy("OUTPUT0"), x)
    assert _retries_for(MODEL, protocol) == before + 1
    # without a policy the fault reaches the caller: a 503 / UNAVAILABLE,
    # or over HTTP a connection broken inside the response
    h.core.chaos = tchaos.ChaosInjector(rate=1.0, kinds=[kind],
                                        max_faults=1, seed=1)
    mod, c = _client("port", protocol, h)
    e = _err(lambda: c.infer(MODEL, _inputs(mod)))
    c.close()
    if protocol == "http" and kind == "abort":
        assert isinstance(e, http.client.IncompleteRead)
        assert tres.is_connection_error(e)
    else:
        assert tres.normalized_status(e) in ("503", "UNAVAILABLE")


@pytest.mark.parametrize("protocol", ["http", "grpc"])
def test_async_infer_honours_the_policy(servers, protocol):
    h = servers["port"]
    h.core.chaos = tchaos.ChaosInjector(rate=1.0, kinds=["error"],
                                        max_faults=1, seed=8)
    mod = tgrpc if protocol == "grpc" else thttp
    c = (tgrpc.InferenceServerClient(h.http_url) if protocol == "grpc"
         else thttp.InferenceServerClient(h.http_url, concurrency=2))
    x = _x()
    r = c.async_infer(MODEL, _inputs(mod, x),
                      retry_policy=tres.RetryPolicy(**POLICY),
                      deadline_s=30.0).get_result(timeout=30)
    c.close()
    np.testing.assert_array_equal(r.as_numpy("OUTPUT0"), x)


def test_client_level_policy_retries_health_and_metadata(servers):
    h = servers["port"]
    h.core.accepting = False  # 503 on infer; readiness false
    with thttp.InferenceServerClient(
            h.http_url, retry_policy=tres.RetryPolicy(
                max_attempts=2, initial_backoff_s=0.01)) as c:
        before = _retries_for("", "http")
        assert c.is_server_ready() is False
        assert c.get_server_metadata()["name"]
        # infer is not retried without retry_infer
        e = _err(lambda: c.infer(MODEL, _inputs(thttp)))
        assert e.status() == "503" and e.retry_after_s == 0.25
    assert _retries_for("", "http") == before


def test_injected_fault_pinned_with_chaos_marker(servers):
    h = servers["port"]
    h.core.chaos = tchaos.ChaosInjector(rate=1.0, kinds=["error"],
                                        max_faults=1, seed=6)
    with thttp.InferenceServerClient(h.http_url) as c:
        _err(lambda: c.infer(MODEL, _inputs(thttp)))
    snap = h.core.flight_recorder.snapshot(model=MODEL)
    chaotic = [o for o in snap["outliers"] if o["chaos"] == "error"]
    assert chaotic and chaotic[-1]["capture_reason"] == "failed"
    text = urllib.request.urlopen(
        f"http://{h.http_url}/metrics").read().decode()
    assert 'nv_chaos_injected_total{model="%s"} 1' % MODEL in text


class _Recorder(BaseHTTPRequestHandler):
    """A stub that answers every request 503 with a short pushback and
    keeps what each attempt carried."""

    protocol_version = "HTTP/1.1"
    seen = []

    def log_message(self, *a):
        pass

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        timeout = self.headers.get("triton-timeout-us")
        if self.path.startswith("/inference."):
            msg = next(p for f, p in iter_frames([body]))
            req = pb.ModelInferRequest.FromString(msg)
            timeout = req.parameters["timeout"].int64_param
            payload = trailers(StatusCode.UNAVAILABLE, "busy",
                               {"retry-after-ms": "20"})
            self.send_response(200)
            self.send_header("Content-Type", "application/grpc-web+proto")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)
        else:
            payload = b'{"error": "busy"}'
            self.send_response(503)
            self.send_header("triton-retry-after-ms", "20")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)
        self.seen.append((self.headers.get("triton-tenant"), int(timeout)))


@pytest.mark.parametrize("protocol", ["http", "grpc"])
def test_each_attempt_carries_the_remaining_deadline(protocol):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Recorder)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    _Recorder.seen = []
    url = f"127.0.0.1:{srv.server_address[1]}"
    mod = tgrpc if protocol == "grpc" else thttp
    try:
        with mod.InferenceServerClient(url) as c:
            t0 = time.monotonic()
            e = _err(lambda: c.infer(
                MODEL, _inputs(mod), tenant="t1", deadline_s=10.0,
                retry_policy=tres.RetryPolicy(max_attempts=3,
                                              retry_infer=True)))
            took = time.monotonic() - t0
        assert tres.normalized_status(e) in ("503", "UNAVAILABLE")
        assert e.retry_after_s == 0.02
        seen = _Recorder.seen
        assert [t for t, _ in seen] == ["t1"] * 3
        budgets = [us for _, us in seen]
        assert 10e6 >= budgets[0] > budgets[1] > budgets[2] > 9e6
        # two pushbacks of 20 ms between the attempts
        assert budgets[0] - budgets[2] >= 40e3 and took >= 0.04
    finally:
        srv.shutdown()
        srv.server_close()


# -- drain -------------------------------------------------------------------

def test_drain_finishes_in_flight_and_refuses_new(servers):
    h = servers["port"]
    t = _occupy(h, delay_ms=500)
    results = {}
    drainer = threading.Thread(
        target=lambda: results.setdefault("drained", h.core.drain(10.0)))
    drainer.start()
    time.sleep(0.05)
    status, msg, headers = _raw_infer(h.http_url)
    assert (status, msg) == (503, "server is shutting down")
    assert headers == {"Retry-After": "1", "triton-retry-after-ms": "250"}
    with thttp.InferenceServerClient(h.http_url) as c:
        assert c.is_server_ready() is False
    drainer.join(timeout=30)
    t.join(timeout=30)
    assert results["drained"] is True
    assert h.core.registry.get(MODEL).stats.pending_count == 0


def test_cli_server_drains_on_sigterm(tmp_path):
    """``python -m triton_client_tpu_torch.server`` on SIGTERM: the request
    in flight (held 1 s by a chaos latency fault) answers, a new one gets
    503 with Retry-After, and the process exits 0 within
    ``--drain-timeout``."""
    port = free_port()
    log = open(tmp_path / "server.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "triton_client_tpu_torch.server",
         "--device", "cpu", "--http-port", str(port), "--grpc-port", "0",
         "--metrics-port", "0", "--drain-timeout", "20", "--chaos", "1.0", "--chaos-kinds",
         "latency", "--chaos-latency-ms", "1000", "--chaos-model", MODEL],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), stdout=log,
        stderr=subprocess.STDOUT)
    url = f"127.0.0.1:{port}"
    try:
        end = time.monotonic() + 120
        while True:
            try:
                urllib.request.urlopen(f"http://{url}/v2/health/ready",
                                       timeout=5)
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < end
                time.sleep(0.1)
        in_flight = {}
        t = threading.Thread(
            target=lambda: in_flight.setdefault("r", _raw_infer(url)))
        t.start()
        time.sleep(0.3)
        t_sig = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        time.sleep(0.2)
        refused = _raw_infer(url)
        code = proc.wait(timeout=30)
        took = time.monotonic() - t_sig
        t.join(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    assert in_flight["r"][0] == 200
    assert refused[0] == 503 and refused[2]["Retry-After"] == "1"
    assert code == 0 and took < 20


# -- perf_analyzer --------------------------------------------------------------

def _pa(h, *args):
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tpa.main(["-m", MODEL, "-u", h.http_url, "-v",
                       "--measurement-interval", "1500", *args])
    lines = out.getvalue().splitlines()
    return rc, [json.loads(ln.split("result ", 1)[1]) for ln in lines
                if ln.startswith("  result ")], out.getvalue()


def test_perf_analyzer_classes_and_retries(servers):
    h = servers["port"]
    rc, results, text = _pa(h, "--concurrency-range", "4", "--priority",
                            "0", "--tenant", "gold", "--priority", "3")
    assert rc == 0
    res = results[0]
    assert [(c["priority"], c["tenant"], c["workers"])
            for c in res["classes"]] == [(0, "gold", 2), (3, "gold", 2)]
    assert sum(c["throughput"] for c in res["classes"]) == \
        pytest.approx(res["throughput"])
    assert "tier p=0 tenant=gold:" in text and "tier p=3 tenant=gold:" in text
    tenants = h.core.qos.tenant_request_counts()
    assert tenants.get(("gold", 0)) and tenants.get(("gold", 3))
    h.core.chaos = tchaos.ChaosInjector(rate=0.3, kinds=["error", "abort"],
                                        seed=3, transient_s=0.2)
    rc, results, _ = _pa(h, "--concurrency-range", "2", "--retries", "3")
    injected = h.core.chaos.injected_total
    h.core.chaos = None
    assert rc == 0
    res = results[0]
    assert res["errors"] == 0 and res["retries_run"] == injected > 0
    assert res["retries"] <= res["retries_run"]
