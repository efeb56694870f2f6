"""Device statistics, the SLO engine and the flight recorder of the port
against the JAX package's, on the CPU.

* The collector: one fixed sequence of executions (signature events with
  and without a cost), batcher ticks and transfers, on injected clocks,
  gives both packages' collectors the same snapshot, metric rows, duty
  cycle, live MFU and pad waste (the peaks set equal through the
  reference's environment overrides: the defaults are each card's own).
* The SLO engine on synthetic time: the same burn rates, budgets, breach
  verdicts, rows and snapshots; ``parse_slo_spec`` the same answers and
  errors.
* Served: the same requests, one after another, to both servers give the
  same tick rows (bucket, requests, real and padded rows, pad waste, queue
  depth), executions, inferences and signature events per model; the
  device memory family is absent on the CPU in both.
* The flight recorder: the same threshold and limit parsing; served
  traffic fills the ring, and a failed request and (under an absolute
  threshold) a slow one are pinned with the same capture reasons, outcome
  texts and span trees; the debug snapshots over HTTP and gRPC are the
  same JSON.
* The server's flags: a junk ``--capture-slower-than`` or ``--slo`` fails
  at start-up.
"""

import json

import numpy as np
import pytest

import jax

from triton_client_tpu.models import language as jlang
from triton_client_tpu.models import transformer as jtr
from triton_client_tpu.models import zoo as jzoo
from triton_client_tpu.server import costs as jcosts
from triton_client_tpu.server import device_stats as jds
from triton_client_tpu.server import flight_recorder as jfr
from triton_client_tpu.server.registry import ModelRegistry as JaxRegistry
from triton_client_tpu.server.testing import ServerHarness as JaxHarness
from triton_client_tpu.server.types import InferError as JInferError
from triton_client_tpu_torch import grpc as tgrpc
from triton_client_tpu_torch import http as thttp
from triton_client_tpu_torch.models import language as tlang
from triton_client_tpu_torch.models import zoo as tzoo
from triton_client_tpu_torch.server import __main__ as tmain
from triton_client_tpu_torch.server import costs as tcosts
from triton_client_tpu_torch.server import device_stats as tds
from triton_client_tpu_torch.server import flight_recorder as tfr
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import ServerHarness
from triton_client_tpu_torch.server.types import InferError
from triton_client_tpu_torch.utils import InferenceServerException

S = 512


@pytest.fixture
def equal_peaks(monkeypatch):
    monkeypatch.setenv("TRITON_TPU_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("TRITON_TPU_PEAK_BYTES_PER_S", "1e10")


def _drive(mod, costs):
    """One fixed sequence of records into a fresh collector of ``mod``."""
    ds = mod.DeviceStatsCollector(window_s=30.0)
    ds._started_s = 0.0
    sig_a = (("X", (8, 16), "float32"),)
    sig_b = (("X", (16, 16), "float32"),)
    ds.declare_model("m", 2e9)
    ds.declare_model("undeclared", None)
    cost = costs.SignatureCost(flops=4e10, bytes_accessed=2e9,
                               argument_bytes=512, output_bytes=512)
    # first sighting: a signature event with its cost, out of the window
    ds.record_execute("m", 5, int(3e9), signature=sig_a, now=1.0,
                      cost=cost, padded_batch=8)
    for i in range(4):
        ds.record_execute("m", 6, int(2e8), signature=sig_a,
                          now=2.0 + i, padded_batch=8)
    ds.record_execute("m", 16, int(5e8), signature=sig_b, now=8.0,
                      padded_batch=16)
    ds.record_execute("m", 12, int(4e8), signature=sig_b, now=9.0,
                      padded_batch=16)
    ds.record_execute("undeclared", 1, int(1e7), now=9.5)
    for batch, padded, depth in ((5, 8, 2), (6, 8, 0), (12, 16, 3)):
        ds.record_tick("m", bucket=padded, batch=batch, padded=padded,
                       queue_depth=depth, assembly_ns=12_345,
                       compute_ns=int(2e8), requests=batch // 2 + 1,
                       syncs=1, flops=4e10 * batch / 8,
                       bytes_accessed=2e9)
    ds.record_transfer("d2h", 4096, count=2)
    ds.record_transfer("h2d", 1000)
    return ds


def test_collector_matches_reference(equal_peaks):
    t, j = _drive(tds, tcosts), _drive(jds, jcosts)
    # the signature event carries the count: 4e10 FLOPs over 8 padded rows
    m = t.snapshot(now=9.5)["models"]["m"]
    assert m["flops_source"] == "measured"
    assert m["flops_per_element"] == 5e9
    assert m["compile"]["count"] == 2 and m["compile"]["jit_cache_hits"] == 5
    assert 0 < m["live_mfu"] <= 1
    for now in (9.5, 20.0, 60.0):
        ts, js = t.snapshot(now=now), j.snapshot(now=now)
        assert ts.pop("hbm") == js.pop("hbm") == {}
        assert ts == js
        tr, jr = t.metric_rows(now=now), j.metric_rows(now=now)
        assert tr == jr
        for model in ("m", "undeclared", "unknown"):
            assert t.duty_cycle(model, now) == j.duty_cycle(model, now)
            assert t.live_mfu(model, now) == j.live_mfu(model, now)
        assert t.pad_waste("m") == j.pad_waste("m") == pytest.approx(
            1 - 23 / 32)


def test_disabled_collector_records_nothing():
    ds = tds.DeviceStatsCollector()
    ds.enabled = False
    ds.record_execute("m", 1, int(1e9))
    ds.record_tick("m", 8, 4, 8, 0, 1000)
    ds.record_transfer("h2d", 64)
    snap = ds.snapshot()
    assert snap["models"] == {} and snap["ticks"] == {} and \
        snap["transfers"] == {}


def test_note_peak_keeps_the_peak_since_start():
    ds = tds.DeviceStatsCollector()
    ds.note_peak("cuda:0", 100)
    ds.note_peak("cuda:0", 50)
    assert ds._peak_floor == {"cuda:0": 100}
    # no card here: no device memory rows, never made up
    assert ds.hbm_stats() == {}
    rows = ds.metric_rows()
    assert rows["mem_used"] == rows["mem_peak"] == rows["mem_limit"] == []


def _slo(mod):
    eng = mod.SloEngine(burn_threshold=2.0)
    eng.set_objective("m", mod.SloObjective(p99_ms=10.0, availability=0.9))
    eng.resolver = lambda name: (mod.SloObjective(p99_ms=5.0)
                                 if name == "r" else None)
    pins = []
    for i in range(120):
        now = 1000.0 + i * 5.0
        for model in ("m", "r", "none"):
            # every third request slow, every seventh failed
            us = 20_000.0 if i % 3 == 0 else 1_000.0
            pins.append(eng.observe(model, us, ok=i % 7 != 0, now=now))
    return eng, pins


def test_slo_engine_matches_reference():
    (t, tp), (j, jp) = _slo(tds), _slo(jds)
    assert tp == jp and any(tp)
    for now in (1100.0, 1600.0, 5000.0):
        for model in ("m", "r", "none"):
            for w in tds.SLO_WINDOWS.values():
                assert t.burn_rate(model, w, now) == j.burn_rate(model, w,
                                                                   now)
            assert t.budget_remaining(model, now) == \
                j.budget_remaining(model, now)
            assert t.breached(model, now) == j.breached(model, now)
        assert t.metric_rows(now) == j.metric_rows(now)
        assert t.snapshot(now=now) == j.snapshot(now=now)


@pytest.mark.parametrize("spec", [
    "m=250", "m=1.5:0.99", "m", "=5", "m=x", "m=-1", "m=5:1.5", "m=5:x",
    "bert_large=100:0.999"])
def test_parse_slo_spec_matches_reference(spec):
    def parse(mod):
        try:
            name, obj = mod.parse_slo_spec(spec)
            return name, obj.p99_ms, obj.availability
        except ValueError as e:
            return str(e)
    assert parse(tds) == parse(jds)


@pytest.mark.parametrize("spec", ["p50", "p99", "P999", "250", "1.5",
                                  "nan", "-3", "0", "p42", "fast"])
def test_capture_threshold_parsing_matches_reference(spec):
    def parse(mod, err):
        try:
            return mod.parse_capture_threshold(spec)
        except err as e:
            return str(e)
    assert parse(tfr, InferError) == parse(jfr, JInferError)


@pytest.mark.parametrize("value", [0, "5", "-1", "x", None, 2.5])
def test_snapshot_limit_parsing_matches_reference(value):
    def parse(mod, err):
        try:
            return mod.parse_snapshot_limit(value)
        except err as e:
            return str(e)
    assert parse(tfr, InferError) == parse(jfr, JInferError)


@pytest.fixture(scope="module")
def servers():
    jreg = JaxRegistry()
    for m in (jzoo.make_simple(), jlang.make_longctx_tpu(),
              jzoo.make_dense_tpu()):
        jreg.register_model(m)
    longctx = {k: np.asarray(v) for k, v in jtr.init_params(
        jax.random.PRNGKey(11), jlang.longctx_cfg()).items()}
    treg = ModelRegistry()
    for m in (tzoo.make_simple(), tlang.make_longctx_tpu("cpu",
                                                         params=longctx),
              tzoo.make_dense_tpu("cpu")):
        treg.register_model(m)
    with JaxHarness(jreg) as jh, ServerHarness(treg) as th:
        yield {"jax": jh, "port": th}


def _infer(url, model, arrays):
    with thttp.InferenceServerClient(url) as c:
        ins = []
        for name, dt, arr in arrays:
            i = thttp.InferInput(name, list(arr.shape), dt)
            i.set_data_from_numpy(arr)
            ins.append(i)
        return c.infer(model, ins)


def _sequence():
    rng = np.random.default_rng(4)
    a = rng.integers(-9, 9, (1, 16)).astype(np.int32)
    seq = [("simple", [("INPUT0", "INT32", a), ("INPUT1", "INT32", a)])] * 3
    for rows in (3, 3, 8, 9):
        seq.append(("dense_tpu", [("INPUT", "FP32", rng.standard_normal(
            (rows, 512)).astype(np.float32))]))
    for rows in (2, 2, 1):
        seq.append(("longctx_tpu", [("TOKENS", "INT32", rng.integers(
            0, 256, (rows, S)).astype(np.int32))]))
    return seq


def test_served_statistics_match_reference(servers):
    got = {}
    for pkg, h in servers.items():
        h.core.device_stats.reset()
        for model, arrays in _sequence():
            _infer(h.http_url, model, arrays)
        with thttp.InferenceServerClient(h.http_url) as c:
            snap = c.get_device_stats()
        got[pkg] = {
            "ticks": {m: {b: {k: t[k] for k in (
                "ticks", "requests", "batch_total", "padded_total",
                "pad_waste", "max_queue_depth", "avg_batch")}
                for b, t in buckets.items()}
                for m, buckets in snap["ticks"].items()},
            "models": {m: (e["executions"], e["inferences"],
                           e["compile"]["count"],
                           e["compile"]["jit_cache_hits"])
                       for m, e in snap["models"].items()},
            "hbm": snap["hbm"],
            "slo": snap["slo"],
        }
        for m in ("dense_tpu", "longctx_tpu"):
            # live MFU is rounded to 6 places: a CPU's share of the card's
            # peak may read 0, but the series is there
            e = snap["models"][m]
            assert 0 < e["duty_cycle"] <= 1 and e["live_mfu"] is not None \
                and e["live_mfu"] >= 0, (pkg, e)
    assert got["port"] == got["jax"]
    # pad waste is rounded to 4 places in the snapshot
    assert got["port"]["ticks"]["dense_tpu"]["8"]["pad_waste"] == \
        pytest.approx(1 - 14 / 24, abs=1e-4)
    assert got["port"]["models"]["longctx_tpu"][2] == 2  # B = 2, then 1


def test_device_memory_family_is_absent_on_the_cpu(servers):
    import urllib.request

    for h in servers.values():
        text = urllib.request.urlopen(
            f"http://{h.http_url}/metrics").read().decode()
        assert not any(line.startswith("nv_tpu_memory_")
                       for line in text.splitlines())


def _pinned(url, model, arrays):
    try:
        _infer(url, model, arrays)
    except InferenceServerException:
        pass


def _outliers(snap):
    return [(o["model"], o["capture_reason"], o["outcome"],
             [(s["name"], s["parent"]) for s in o["spans"]])
            for o in snap["outliers"]]


def test_flight_recorder_matches_reference(servers):
    got = {}
    a = np.zeros((1, 16), np.int32)
    bad = [("INPUT0", "INT32", np.zeros((1, 8), np.int32)),
           ("INPUT1", "INT32", np.zeros((1, 8), np.int32))]
    for pkg, h in servers.items():
        fr = h.core.flight_recorder
        fr.reset()
        fr.configure(capture_slower_than="p99")
        for _ in range(3):
            _infer(h.http_url, "simple", [("INPUT0", "INT32", a),
                                          ("INPUT1", "INT32", a)])
        _pinned(h.http_url, "simple", bad)
        fr.configure(capture_slower_than="0.000001")
        _infer(h.http_url, "dense_tpu", [("INPUT", "FP32", np.ones(
            (2, 512), np.float32))])
        fr.configure(capture_slower_than="p99")
        with thttp.InferenceServerClient(h.http_url) as c:
            http_snap = c.get_flight_recorder(limit=2)
            model_snap = c.get_flight_recorder("simple")
        with tgrpc.InferenceServerClient(h.http_url) as c:
            grpc_snap = c.get_flight_recorder(limit=2)
        for snap in (http_snap, grpc_snap):
            for o in snap["outliers"]:
                o.pop("age_s")
        assert http_snap["outliers"] == grpc_snap["outliers"]
        got[pkg] = {
            "recorded": http_snap["recorded_total"],
            "recent": [(r["model"], r["batch"], r["outcome"],
                        r["captured"], r["protocol"], sorted(r))
                       for r in http_snap["recent"]],
            "outliers": _outliers(http_snap),
            "models": sorted(http_snap["models"]),
            "keys": sorted(http_snap),
            "simple": (model_snap["models"]["simple"]["count"],
                       len(model_snap["recent"])),
        }
    assert got["port"] == got["jax"]
    reasons = [o[1] for o in got["port"]["outliers"]]
    assert reasons == ["failed", "slow"]


@pytest.mark.parametrize("flags", [
    ["--capture-slower-than", "nan"], ["--slo", "bert_large"],
    ["--slo", "m=5:2"], ["--slo-burn-threshold", "0"]])
def test_server_flags_fail_at_start_up(flags, capsys):
    with pytest.raises(SystemExit) as e:
        tmain.main(["--device", "cpu", "--metrics-port", "0", *flags])
    assert e.value.code == 2
    assert "error" in capsys.readouterr().err


def test_device_stats_rpc_and_route_agree(servers):
    h = servers["port"]
    with thttp.InferenceServerClient(h.http_url) as c:
        via_http = c.get_device_stats("simple")
        costs_http = c.get_costs()
    with tgrpc.InferenceServerClient(h.http_url) as c:
        via_grpc = c.get_device_stats("simple")
        costs_grpc = c.get_costs()
    for snap in (via_http, via_grpc):
        for m in snap["models"].values():
            m.pop("duty_cycle")
            m.pop("live_mfu")
    assert via_http == via_grpc and set(via_http["models"]) <= {"simple"}
    assert costs_http == costs_grpc
    assert json.dumps(via_http)
