"""Request tracing of the port's server against the JAX package's, on the CPU.

Both packages' in-process servers serve ``simple``, the tiny
``longctx_tpu`` (the reference's seed-11 weights, carried to the port as
numpy arrays), the batched fixture ``dense_tpu`` and the decoupled
``repeat_int32``; the port's HTTP and gRPC clients send both the same
requests (gRPC: gRPC-Web on each server's HTTP port).

* Span trees: a traced request gives the same span names, parents and
  order, the same timestamp names and record keys, and the same tick and
  cost stamps (less their times), by HTTP, gRPC unary and a gRPC stream; a
  decoupled stream gives one stream record with the same spans and token
  count.  Times are not compared.
* Sampling: ``trace_rate``, ``trace_count``, a model's own settings, and
  ``log_frequency`` rotation write the same records and files in both.
* Refusals: ``TENSORS`` with the reference's status and text over both
  protocols; unknown keys, a zero rate and ``PROFILE`` in a model's scope
  with the same statuses.
* ``PROFILE`` writes a torch.profiler trace directory.
* Formats: the reference's own ``tools.trace_summary.summarize`` reads the
  port's file and gives the stage set it gives for its own file, and the
  port's tool (``tools.trace_summary``) summarizes both files as the
  reference does.
* Settings: trace and log settings responses equal field for field, over
  HTTP (both packages' clients) and gRPC (the port's client on both
  servers, the reference's on its own HTTP/2 port).
"""

import json
import os
import queue
import time

import numpy as np
import pytest

import jax

from triton_client_tpu import grpc as jgrpc
from triton_client_tpu import http as jhttp
from triton_client_tpu.models import language as jlang
from triton_client_tpu.models import transformer as jtr
from triton_client_tpu.models import zoo as jzoo
from triton_client_tpu.server.registry import ModelRegistry as JaxRegistry
from triton_client_tpu.server.testing import ServerHarness as JaxHarness
from triton_client_tpu.tools import trace_summary as jsummary
from triton_client_tpu_torch.tools import trace_summary as tsummary
from triton_client_tpu_torch import grpc as tgrpc
from triton_client_tpu_torch import http as thttp
from triton_client_tpu_torch.models import language as tlang
from triton_client_tpu_torch.models import zoo as tzoo
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import ServerHarness
from triton_client_tpu_torch.utils import InferenceServerException

S = 512  # the tiny longctx_tpu window
D = 512  # dense_tpu's width


@pytest.fixture(scope="module")
def servers():
    jreg = JaxRegistry()
    for m in (jzoo.make_simple(), jlang.make_longctx_tpu(),
              jzoo.make_dense_tpu(), jzoo.make_repeat_int32()):
        jreg.register_model(m)
    longctx = {k: np.asarray(v) for k, v in jtr.init_params(
        jax.random.PRNGKey(11), jlang.longctx_cfg()).items()}
    treg = ModelRegistry()
    for m in (tzoo.make_simple(), tlang.make_longctx_tpu("cpu",
                                                         params=longctx),
              tzoo.make_dense_tpu("cpu"), tzoo.make_repeat_int32()):
        treg.register_model(m)
    with JaxHarness(jreg) as jh, ServerHarness(treg) as th:
        yield {"jax": jh, "port": th}


def _urls(servers):
    return {pkg: h.http_url for pkg, h in servers.items()}


def _records(path, n, timeout=20.0):
    """The first ``n`` records of a trace file, waiting for them (the
    port's HTTP frontend emits after it wrote the response)."""
    deadline = time.monotonic() + timeout
    while True:
        lines = []
        if os.path.exists(path):
            with open(path) as f:
                lines = [ln for ln in f if ln.strip()]
        if len(lines) >= n or time.monotonic() > deadline:
            return [json.loads(ln) for ln in lines]
        time.sleep(0.02)


def _set(url, **settings):
    with thttp.InferenceServerClient(url) as c:
        return c.update_trace_settings(settings={
            k: v if isinstance(v, list) or v is None else [str(v)]
            for k, v in settings.items()})


def _traced(url, path, send, n=1, **settings):
    """Trace every request into ``path`` while ``send(url)`` runs; the
    records, once ``n`` are in."""
    _set(url, **{"trace_file": str(path), "trace_level": "TIMESTAMPS",
                 "trace_rate": 1, "trace_count": -1, "log_frequency": 0,
                 **settings})
    try:
        send(url)
    finally:
        _set(url, trace_level="OFF")
    return _records(str(path), n)


def _inputs(mod, arrays):
    ins = []
    for name, dt, arr in arrays:
        i = mod.InferInput(name, list(arr.shape), dt)
        i.set_data_from_numpy(arr)
        ins.append(i)
    return ins


def _request(model):
    rng = np.random.default_rng(3)
    if model == "simple":
        a = rng.integers(-9, 9, (1, 16)).astype(np.int32)
        return [("INPUT0", "INT32", a), ("INPUT1", "INT32", a)]
    if model == "longctx_tpu":
        return [("TOKENS", "INT32",
                 rng.integers(0, 256, (2, S)).astype(np.int32))]
    return [("INPUT", "FP32", rng.standard_normal((3, D)).astype(
        np.float32))]


def _send(model, protocol, arrays=None):
    arrays = arrays if arrays is not None else _request(model)

    def send(url):
        if protocol == "http":
            with thttp.InferenceServerClient(url) as c:
                c.infer(model, _inputs(thttp, arrays))
            return
        with tgrpc.InferenceServerClient(url) as c:
            if protocol == "grpc":
                c.infer(model, _inputs(tgrpc, arrays))
                return
            q = queue.Queue()
            c.start_stream(lambda result, error: q.put((result, error)))
            c.async_stream_infer(model, _inputs(tgrpc, arrays))
            _, err = q.get(timeout=120)
            c.stop_stream()
            assert err is None, err
    return send


def _shape(rec):
    """What two packages' records of one request must share: span names,
    parents and order, timestamp names, record keys (less the
    ``replica`` the reference's harness stamps), and the tick and cost
    stamps less their times and FLOP counts (each package counts its own
    way; test_torch_costs.py holds the counts)."""
    tick = rec.get("tick")
    cost = rec.get("cost")
    return {
        "spans": [(s["name"], s["parent"]) for s in rec["spans"]],
        "timestamps": [t["name"] for t in rec["timestamps"]],
        # the reference's test harness stamps the replica it serves as
        "keys": sorted(k for k in rec if k != "replica"),
        "tick": ({k: v for k, v in tick.items() if k != "assembly_us"}
                 if tick else None),
        "cost": ({k: v for k, v in cost.items()
                  if k not in ("device_us", "flops", "roofline")}
                 if cost else None),
    }


#: the client's trace context in a record: the reference's gRPC-Web
#: bridge hands its servicer no metadata, so its gRPC records lack them
#: (its HTTP/2 servicer records them, ``_read_trace_metadata``); the
#: port's gRPC-Web servicer reads them from the call's headers
_TRACE_KEYS = ("traceparent", "triton_request_id")


def _without_bridge_loss(shape, protocol):
    """The port's record shape less the trace-context keys a gRPC-Web call
    carries (checked present first), to hold against the reference
    bridge's."""
    if protocol == "http":
        return shape
    assert set(_TRACE_KEYS) <= set(shape["keys"]), shape["keys"]
    return {**shape, "keys": [k for k in shape["keys"]
                              if k not in _TRACE_KEYS]}


@pytest.mark.parametrize("protocol", ["http", "grpc", "stream"])
@pytest.mark.parametrize("model", ["simple", "longctx_tpu", "dense_tpu"])
def test_span_trees_match_reference(servers, tmp_path, model, protocol):
    got = {}
    for pkg, url in _urls(servers).items():
        recs = _traced(url, tmp_path / f"{pkg}.json",
                       _send(model, protocol))
        assert len(recs) == 1, (pkg, recs)
        got[pkg] = _shape(recs[0])
        assert recs[0]["model_name"] == model
        spans = recs[0]["spans"]
        root = spans[0]
        assert root["name"] == "REQUEST" and root["parent"] is None
        for s in spans[1:]:
            assert root["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= root["end_ns"], (pkg, s)
    got["port"] = _without_bridge_loss(got["port"], protocol)
    assert got["port"] == got["jax"]
    names = [n for n, _ in got["port"]["spans"]]
    assert "COMPUTE" in names and "D2H_TRANSFER" in names
    assert ("DECODE" in names) == (protocol != "stream")
    assert ("BATCH_ASSEMBLY" in names) == (model != "simple")


def test_decoupled_stream_record_matches_reference(servers, tmp_path):
    arrays = [("IN", "INT32", np.array([4, 5, 6], np.int32)),
              ("DELAY", "UINT32", np.zeros(3, np.uint32)),
              ("WAIT", "UINT32", np.zeros(1, np.uint32))]
    got = {}
    for pkg, url in _urls(servers).items():
        def send(u):
            with tgrpc.InferenceServerClient(u) as c:
                seen = []
                c.start_stream(lambda result, error: seen.append(
                    (result, error)))
                c.async_stream_infer("repeat_int32",
                                     _inputs(tgrpc, arrays))
                c.stop_stream()
                assert all(e is None for _, e in seen), seen
        recs = _traced(url, tmp_path / f"{pkg}.json", send)
        assert len(recs) == 1, recs
        rec = recs[0]
        shape = _shape(rec)
        if pkg == "port":
            shape = _without_bridge_loss(shape, "stream")
        got[pkg] = (shape, rec["tokens"], rec["outcome"],
                    rec["cache_hit_tokens"], rec["prefix_hash"])
    assert got["port"] == got["jax"]
    assert got["port"][1] == 3 and got["port"][2] == "ok"


def _count(url, path, n_requests, model="simple", n_wait=None, **settings):
    recs = _traced(url, path, lambda u: [
        _send(model, "http")(u) for _ in range(n_requests)],
        n=n_wait if n_wait is not None else n_requests, **settings)
    return len(recs)


def test_rate_and_count_sampling_match_reference(servers, tmp_path):
    got = {}
    for pkg, url in _urls(servers).items():
        # every 3rd request of 7: the 1st, 4th and 7th
        by_rate = _count(url, tmp_path / f"{pkg}-rate.json", 7, n_wait=3,
                         trace_rate=3)
        # a budget of 2 of 4
        by_count = _count(url, tmp_path / f"{pkg}-count.json", 4, n_wait=2,
                          trace_count=2)
        got[pkg] = (by_rate, by_count)
    assert got["port"] == got["jax"] == (3, 2)


def test_per_model_settings_match_reference(servers, tmp_path):
    got = {}
    for pkg, url in _urls(servers).items():
        path = tmp_path / f"{pkg}-model.json"
        _set(url, trace_level="OFF")
        with thttp.InferenceServerClient(url) as c:
            eff = c.update_trace_settings("simple", {
                "trace_file": [str(path)], "trace_level": ["TIMESTAMPS"],
                "trace_rate": ["1"]})
            for model in ("simple", "dense_tpu", "simple"):
                _send(model, "http")(url)
            recs = _records(str(path), 2)
            # null in the model's scope inherits the global value again
            cleared = c.update_trace_settings("simple", {
                "trace_level": None, "trace_file": None,
                "trace_rate": None})
            glob = c.get_trace_settings()
        got[pkg] = ([r["model_name"] for r in recs],
                    {k: v for k, v in eff.items() if k != "trace_file"},
                    {k: v for k, v in cleared.items() if k != "trace_file"},
                    cleared["trace_file"] == glob["trace_file"])
    assert got["port"] == got["jax"]
    assert got["port"][0] == ["simple", "simple"]


def test_log_frequency_rotation_matches_reference(servers, tmp_path):
    got = {}
    for pkg, url in _urls(servers).items():
        base = tmp_path / f"{pkg}-rot.json"
        _set(url, trace_file=str(base), trace_level="TIMESTAMPS",
             trace_rate=1, trace_count=-1, log_frequency=2)
        try:
            for _ in range(5):
                _send("simple", "http")(url)
        finally:
            _set(url, trace_level="OFF", log_frequency=0)
        _records(f"{base}.2", 1)
        got[pkg] = {name[len(base.name):]: len(_records(
            str(tmp_path / name), 0))
            for name in sorted(os.listdir(tmp_path))
            if name.startswith(base.name)}
    assert got["port"] == got["jax"] == {".0": 2, ".1": 2, ".2": 1}


def _http_error(url, path, body):
    import urllib.request

    req = urllib.request.Request(f"http://{url}{path}",
                                 data=json.dumps(body).encode(),
                                 method="POST")
    try:
        urllib.request.urlopen(req).read()
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())["error"]
    raise AssertionError("no error")


def _grpc_error(url, model, settings):
    with tgrpc.InferenceServerClient(url) as c:
        try:
            c.update_trace_settings(model, settings)
        except InferenceServerException as e:
            return e.status(), e.message()
    raise AssertionError("no error")


def test_refusals_match_reference(servers):
    got = {}
    for pkg, url in _urls(servers).items():
        got[pkg] = {
            "tensors http": _http_error(url, "/v2/trace/setting",
                                        {"trace_level": ["TENSORS"]}),
            "tensors grpc": _grpc_error(url, None,
                                        {"trace_level": ["TENSORS"]}),
            "unknown key": _http_error(url, "/v2/trace/setting",
                                       {"trace_bogus": ["1"]}),
            "zero rate": _http_error(url, "/v2/trace/setting",
                                     {"trace_rate": ["0"]}),
            "profile in a model's scope": _http_error(
                url, "/v2/models/simple/trace/setting",
                {"trace_level": ["PROFILE"]})[0],
            "unknown model": _http_error(
                url, "/v2/models/nope/trace/setting", {})[0],
        }
    assert got["port"] == got["jax"]
    status, text = got["port"]["tensors http"]
    assert status == 501 and text.startswith(
        "trace_level TENSORS is not implemented")
    assert got["port"]["tensors grpc"] == ("StatusCode.UNIMPLEMENTED", text)


def test_profile_writes_a_trace_directory(servers, tmp_path):
    url = servers["port"].http_url
    base = tmp_path / "prof.json"
    _set(url, trace_file=str(base), trace_level="PROFILE")
    try:
        _send("simple", "http")(url)
    finally:
        _set(url, trace_level="OFF")
    out = tmp_path / "prof.json.profile"
    files = [f for f in os.listdir(out) if f.endswith(".json")]
    assert files, os.listdir(out)
    with open(out / files[0]) as f:
        assert "traceEvents" in json.load(f)
    # PROFILE alone traces no request timeline
    assert not base.exists()


def test_trace_summary_reads_the_ports_file(servers, tmp_path):
    files = {}
    for pkg, url in _urls(servers).items():
        path = tmp_path / f"{pkg}.json"

        def send(u):
            for model in ("simple", "longctx_tpu", "dense_tpu"):
                _send(model, "http")(u)
        _traced(url, path, send, n=3)
        files[pkg] = str(path)
    stages = {}
    for pkg, path in files.items():
        records = jsummary.load_trace_file(path)
        summary = jsummary.summarize(records)
        stages[pkg] = {m: sorted(e["stages"]) for m, e in
                       summary["models"].items()}
        # the port's tool: the reference's summary, field for field
        assert tsummary.summarize(tsummary.load_trace_file(path)) == summary
        assert tsummary.format_text(summary) == jsummary.format_text(summary)
    assert stages["port"] == stages["jax"]
    assert stages["port"]["dense_tpu"] == sorted(
        ["DECODE", "QUEUE", "BATCH_ASSEMBLY", "COMPUTE", "D2H_TRANSFER",
         "SERIALIZE", "NETWORK_WRITE"])


def _trace_settings(client, as_json=False, **kw):
    if as_json:
        return client.update_trace_settings(as_json=True, **kw)
    return client.update_trace_settings(**kw)


def test_trace_and_log_settings_match_reference(servers, tmp_path):
    path = str(tmp_path / "settings.json")
    steps = [
        ("get", None, None),
        ("update", None, {"trace_file": [path], "trace_rate": ["7"],
                          "trace_count": ["3"]}),
        ("update", "simple", {"trace_rate": ["11"]}),
        ("get", "simple", None),
        ("update", "simple", {"trace_rate": None}),
        ("update", None, {"trace_rate": None, "trace_count": None,
                          "trace_file": None}),
    ]
    got = {}
    for pkg, url in _urls(servers).items():
        # every key back to its default first: null clears
        _set(url, **{k: None for k in ("trace_file", "trace_level",
                                       "trace_rate", "trace_count",
                                       "log_frequency")})
        rows = []
        for mod in (thttp, jhttp):
            with mod.InferenceServerClient(url) as c:
                for what, model, settings in steps:
                    rows.append(c.get_trace_settings(model) if what == "get"
                                else c.update_trace_settings(model,
                                                             settings))
                rows.append(c.get_log_settings())
                rows.append(c.update_log_settings(
                    {"log_verbose_level": 0, "log_format": "default"}))
        with tgrpc.InferenceServerClient(url) as c:
            for what, model, settings in steps:
                rows.append(c.get_trace_settings(model, as_json=True)
                            if what == "get"
                            else c.update_trace_settings(model, settings,
                                                         as_json=True))
            rows.append(c.get_log_settings(as_json=True))
            rows.append(c.update_log_settings({"log_info": True},
                                              as_json=True))
        got[pkg] = rows
    assert got["port"] == got["jax"]
    # and the reference's gRPC client on the reference's HTTP/2 port reads
    # what the port's gRPC client reads from the port
    with jgrpc.InferenceServerClient(servers["jax"].grpc_url) as c:
        ref = c.get_log_settings(as_json=True)
    with tgrpc.InferenceServerClient(servers["port"].http_url) as c:
        assert c.get_log_settings(as_json=True) == ref
