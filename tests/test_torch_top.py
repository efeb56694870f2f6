"""The port's live console (``tools/top.py``) against the reference's, on
the CPU.

* The same ``/metrics`` texts and flight-recorder snapshots, seeded, in
  two samples a few seconds apart so that rates are deltas, go through
  both packages' parsers (``parse_metrics``, ``parse_device``,
  ``parse_qos``, ``parse_costs``), row functions (models, buckets,
  tenants, costs), fleet aggregation (rows, buckets, tenants, costs,
  restarts over several URLs, one of them down) and rendered tables
  (``render``, ``render_fleet``) and the JSON shapes: all equal.  The
  texts cover a label block with a literal ``}`` in a tenant id, unlabeled
  gauges, versions summed per model, buckets with roofline gauges,
  tenants by tier, cost families, burn rates over the threshold, scale
  events between the samples, a counter reset (a restarted server) and
  the supervisor's restart counter.
* Against the port's CPU harness: ``main(["--url", ..., "--once",
  "--json"])`` reads the successes that were sent and the last outlier,
  ``--once`` renders the table, and an unreachable URL exits 1 with
  "cannot poll" on stderr (the reference's
  ``tests/test_flight_recorder.py`` contract).  The restart counter over a
  fleet's frontend is read in ``tests/test_torch_fleet.py``'s SIGKILL
  drill.
"""

import json
import time

import numpy as np
import pytest

from triton_client_tpu.tools import top as jtop
from triton_client_tpu_torch import http as thttp
from triton_client_tpu_torch.server.model import PyModel, make_config
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import ServerHarness
from triton_client_tpu_torch.tools import top as ttop

_TOPS = {"port": ttop, "ref": jtop}
_MODELS = ("simple", "bert_large", "longctx_tpu")
_TENANTS = ("gold", "bulk", 'we}ird"t\\x')


def _esc(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"')


def _line(name, labels, value) -> str:
    if not labels:
        return f"{name} {value}"
    body = ",".join(f'{k}="{_esc(str(v))}"' for k, v in labels.items())
    return f"{name}{{{body}}} {value}"


def metrics_text(rng, scale: float = 1.0, restarted: str = "") -> str:
    """A ``/metrics`` text with every family ``top`` reads; counters grow
    with ``scale``, and ``restarted`` names a model whose counters reset."""
    out = ["# HELP nv_inference_request_success ok", "# TYPE x counter"]

    def c(base):
        return round(base * scale, 3)

    for model in _MODELS:
        k = 0.01 if model == restarted else 1.0
        for version in ("1", "2"):
            lab = {"model": model, "version": version}
            out += [
                _line("nv_inference_request_success", lab,
                      c(k * (500 + rng.integers(0, 100)))),
                _line("nv_inference_request_failure", lab,
                      c(k * rng.integers(0, 9))),
                _line("nv_inference_request_duration_us", lab,
                      c(k * 9e6 * rng.random())),
                _line("nv_inference_queue_duration_us", lab,
                      c(k * 1e6 * rng.random())),
                _line("nv_inference_batch_size_total", lab,
                      c(k * 2000)),
                _line("nv_inference_batch_execution_count", lab,
                      c(k * 300)),
                _line("nv_inference_pending_request_count", lab,
                      int(rng.integers(0, 5))),
                _line("nv_inference_deadline_exceeded_total", lab,
                      c(k * rng.integers(0, 4)))]
        lab = {"model": model}
        out += [
            _line("nv_tpu_duty_cycle", lab, round(rng.random(), 4)),
            _line("nv_tpu_live_mfu", lab, round(rng.random() * 0.3, 4)),
            _line("nv_slo_burn_rate", {**lab, "window": "5m"},
                  round(rng.random() * 30, 2)),
            _line("nv_slo_burn_rate", {**lab, "window": "1h"},
                  round(rng.random() * 30, 2)),
            _line("nv_fleet_instances", lab, int(rng.integers(1, 4))),
            _line("nv_fleet_serving_version", lab, int(rng.integers(1, 3))),
            _line("nv_fleet_scale_total", {**lab, "direction": "out"},
                  int(2 * scale)),
            _line("nv_fleet_scale_total", {**lab, "direction": "in"}, 1),
            _line("nv_mem_inflight_bytes", lab, int(rng.integers(0, 1e8))),
            _line("nv_device_fault_total", {**lab, "kind": "oom"},
                  c(rng.integers(0, 3))),
            _line("nv_device_quarantine", lab, int(model == "bert_large")),
            _line("nv_cache_hit_total", lab, c(rng.integers(0, 90))),
            _line("nv_cache_miss_total", lab, c(rng.integers(0, 90))),
            _line("nv_cache_pinned_bytes", lab, int(rng.integers(0, 1e9)))]
        for bucket in ("8", "16", "128", "tail"):
            blab = {"model": model, "bucket": bucket}
            out += [_line(name, blab, c(rng.integers(1, 999)))
                    for name in ("nv_tpu_tick_total",
                                 "nv_tpu_tick_batch_total",
                                 "nv_tpu_tick_padded_total",
                                 "nv_tpu_tick_assembly_duration_us",
                                 "nv_tpu_tick_queue_depth_total",
                                 "nv_tpu_tick_sync_total",
                                 "nv_tpu_tick_step_total",
                                 "nv_tpu_tick_upload_total")]
            if bucket != "tail":
                out += [
                    _line("nv_tpu_roofline_arithmetic_intensity", blab,
                          round(rng.random() * 200, 2)),
                    _line("nv_tpu_roofline_pct_of_peak",
                          {**blab, "verdict": str(rng.choice(
                              ["compute_bound", "memory_bound"]))},
                          round(rng.random() * 90, 1))]
        for tenant in _TENANTS:
            for tier in ("0", "2"):
                tlab = {"model": model, "tenant": tenant, "tier": tier}
                out += [
                    _line("nv_qos_tenant_requests_total", tlab,
                          c(rng.integers(0, 300))),
                    _line("nv_inference_rejected_total", tlab,
                          c(rng.integers(0, 20))),
                    _line("nv_mem_shed_total", {**tlab, "reason": "bytes"},
                          c(rng.integers(0, 5)))]
            clab = {"model": model, "tenant": tenant}
            out += [
                _line("nv_cost_device_us_total", clab, c(rng.random() * 1e6)),
                _line("nv_cost_flops_total", clab, c(rng.random() * 1e12)),
                _line("nv_cost_tokens_total", clab, c(rng.integers(0, 5e4))),
                _line("nv_cost_kv_byte_seconds_total", clab,
                      c(rng.random() * 1e9))]
        # a model-only series predating the QoS labels
        out.append(_line("nv_inference_rejected_total", {"model": model},
                         c(rng.integers(0, 3))))
    out += [
        _line("nv_slo_burn_threshold", None, 14.4),
        _line("nv_mem_budget_bytes", None, 4e9),
        _line("nv_host_loop_lag_us", {"loop": "frontend-0"},
              round(rng.random() * 9e3, 1)),
        _line("nv_host_loop_lag_us", {"loop": "batcher"},
              round(rng.random() * 9e3, 1)),
        _line("nv_host_gc_pause_us_total", {"generation": "0"},
              c(rng.random() * 1e5)),
        _line("nv_host_gc_pause_us_total", {"generation": "2"},
              c(rng.random() * 1e5)),
        _line("nv_fleet_worker_restart_total", {"worker": "0"},
              int(rng.integers(0, 3))),
        _line("nv_fleet_worker_restart_total", {"worker": "1"}, 1),
        "nv_unrelated_family 7",
        "garbage line without a value"]
    return "\n".join(out) + "\n"


def recorder_snapshot(rng, t_now: float) -> dict:
    outliers = []
    for seq in range(1, 6):
        model = _MODELS[int(rng.integers(0, len(_MODELS)))]
        o = {"model": model, "seq": int(seq * 7 + rng.integers(0, 5)),
             "ts": t_now - 30 + seq,
             "total_us": float(rng.random() * 9e5),
             "capture_reason": str(rng.choice(["slow", "failed"])),
             "outcome": str(rng.choice(["ok", "failed: " + "x" * 60])),
             "chaos": str(rng.choice(["latency", ""])) or None,
             "request_id": f"r{seq}"}
        if seq != 3:  # one from a server without age_s
            o["age_s"] = round(float(rng.random() * 20), 1)
        outliers.append(o)
    return {"enabled": True, "capture_slower_than": "p99",
            "recorded_total": int(rng.integers(100, 999)),
            "models": {m: {"count": int(rng.integers(1, 99)),
                           "p50_ms": round(float(rng.random() * 90), 3),
                           "p99_ms": round(float(rng.random() * 900), 3),
                           "threshold_ms": 12.5,
                           "slow_total": int(rng.integers(0, 9)),
                           "captured_total": int(rng.integers(0, 9))}
                       for m in _MODELS[:2]},
            "recent": [], "outliers": outliers}


def _sample(mod, text, recorder, t):
    return {"t": t, "metrics": mod.parse_metrics(text),
            "qos": mod.parse_qos(text), "device": mod.parse_device(text),
            "costs": mod.parse_costs(text), "recorder": recorder}


def samples(seed: int, restarted: str = ""):
    """(prev text, cur text, recorder, t0, t1) of one server."""
    rng = np.random.default_rng(seed)
    state = rng.bit_generator.state
    prev = metrics_text(rng, 1.0)
    rng.bit_generator.state = state
    cur = metrics_text(rng, 1.7, restarted=restarted)
    rec = recorder_snapshot(np.random.default_rng(seed + 100), 1_000_000.0)
    return prev, cur, rec, 100.0, 102.5


@pytest.fixture
def frozen_clock(monkeypatch):
    """Both consoles stamp the wall clock in headers and outlier ages."""
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "12:34:56")
    monkeypatch.setattr(time, "time", lambda: 1_000_000.0)


SEEDS = [0, 1, 2]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("parser", ["parse_metrics", "parse_device",
                                    "parse_qos", "parse_costs"])
def test_parsers_equal(parser, seed):
    _, text, *_ = samples(seed)
    got = getattr(ttop, parser)(text)
    assert got == getattr(jtop, parser)(text)
    if parser == "parse_qos":
        assert any("}" in tenant for tenant, _tier in got["requests"])
    if parser == "parse_device":
        assert got["burn_threshold"] == 14.4 and got["mem_budget"] == 4e9
        assert got["restarts"] and got["host_lag_us"] is not None


@pytest.mark.usefixtures("frozen_clock")
@pytest.mark.parametrize("restarted", ["", "simple"],
                         ids=["steady", "reset"])
@pytest.mark.parametrize("two", [False, True], ids=["once", "rates"])
@pytest.mark.parametrize("seed", SEEDS)
def test_rows_equal(seed, two, restarted):
    prev_t, cur_t, rec, t0, t1 = samples(seed, restarted)
    rows = {}
    for pkg, mod in _TOPS.items():
        cur = _sample(mod, cur_t, rec, t1)
        prev = _sample(mod, prev_t, rec, t0) if two else None
        rows[pkg] = (mod.model_rows(cur, prev),
                     mod.model_rows(cur, prev, include_idle=True),
                     mod.bucket_rows(cur, prev), mod.tenant_rows(cur, prev),
                     mod.cost_rows(cur, prev))
    assert rows["port"] == rows["ref"]
    models = rows["port"][0]
    assert set(models) == set(_MODELS)
    assert (models["simple"]["qps"] is None) == (not two)
    assert models["bert_large"]["quarantined"]


@pytest.mark.usefixtures("frozen_clock")
@pytest.mark.parametrize("two", [False, True], ids=["once", "rates"])
@pytest.mark.parametrize("seed", SEEDS)
def test_render_equal(seed, two):
    prev_t, cur_t, rec, t0, t1 = samples(seed)
    texts = {}
    for pkg, mod in _TOPS.items():
        cur = _sample(mod, cur_t, rec, t1)
        prev = _sample(mod, prev_t, rec, t0) if two else None
        texts[pkg] = mod.render(
            "localhost:8000", cur, mod.model_rows(cur, prev), 2.0,
            tenants=mod.tenant_rows(cur, prev),
            buckets=mod.bucket_rows(cur, prev),
            costs=mod.cost_rows(cur, prev))
    assert texts["port"] == texts["ref"]
    assert "worker-restarts=" in texts["port"]
    assert "MODEL/BUCKET" in texts["port"] and "TENANT" in texts["port"]


@pytest.mark.usefixtures("frozen_clock")
@pytest.mark.parametrize("two", [False, True], ids=["once", "rates"])
@pytest.mark.parametrize("down", [False, True], ids=["all_up", "one_down"])
def test_fleet_aggregation_and_render_equal(down, two):
    urls = ["http://a:8000", "http://b:8000", "http://c:8000"]
    out = {}
    for pkg, mod in _TOPS.items():
        per_url, tenants, buckets, costs, restarts = {}, {}, {}, {}, {}
        for k, url in enumerate(urls):
            if down and k == 2:
                continue
            prev_t, cur_t, rec, t0, t1 = samples(10 + k)
            cur = _sample(mod, cur_t, rec, t1)
            prev = _sample(mod, prev_t, rec, t0) if two else None
            per_url[url] = mod.model_rows(cur, prev)
            tenants[url] = mod.tenant_rows(cur, prev)
            buckets[url] = mod.bucket_rows(cur, prev)
            costs[url] = mod.cost_rows(cur, prev)
            restarts[url] = cur["device"]["restarts"]
        agg = mod.aggregate_rows(per_url)
        aggs = (agg, mod.aggregate_tenants(tenants),
                mod.aggregate_buckets(buckets), mod.aggregate_costs(costs),
                mod.aggregate_restarts(restarts))
        out[pkg] = (aggs, mod.render_fleet(
            urls, per_url, agg, 2.0, tenants=aggs[1], buckets=aggs[2],
            costs=aggs[3], restarts=aggs[4]),
            mod._buckets_json(aggs[2]), mod._costs_json(aggs[3]))
    assert out["port"] == out["ref"]
    text = out["port"][1]
    assert ("DOWN: http://c:8000" in text) == down
    assert "└ http://a:8000" in text


def test_restarts_dedup_per_worker():
    """Every worker of one fleet exports the same fleet-wide counter: the
    fleet view takes each worker's largest, then sums the workers."""
    per_url = {"a": {"0": 2.0, "1": 1.0}, "b": {"0": 2.0, "1": 1.0},
               "c": {"1": 3.0}, "d": None}
    assert ttop.aggregate_restarts(per_url) == \
        jtop.aggregate_restarts(per_url) == 5


# -- against the port's server -------------------------------------------------

def _boom(inputs, params):
    if int(inputs["X"].reshape(-1)[0]) < 0:
        raise ValueError("negative input")
    return {"Y": inputs["X"] * 2}


@pytest.fixture(scope="module")
def served():
    cfg = make_config("doubler", inputs=[("X", "INT32", [4])],
                      outputs=[("Y", "INT32", [4])], max_batch_size=8,
                      instance_kind="KIND_CPU")
    registry = ModelRegistry()
    registry.register_model(PyModel(cfg, _boom))
    with ServerHarness(registry) as h:
        yield h


def _send(url, n, value=1):
    with thttp.InferenceServerClient(url) as c:
        for k in range(n):
            x = np.full((1, 4), value, np.int32)
            i = thttp.InferInput("X", [1, 4], "INT32")
            i.set_data_from_numpy(x)
            c.infer("doubler", [i], request_id=f"q{k}")


def test_once_json_reads_the_servers_counts(served, capsys):
    _send(served.http_url, 6)
    with pytest.raises(Exception):
        _send(served.http_url, 1, value=-1)  # a failure: the last outlier
    capsys.readouterr()
    assert ttop.main(["--url", served.http_url, "--once", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["url"] == f"http://{served.http_url}"
    rec = out["recorder"]
    assert rec["models"]["doubler"]["count"] == 6  # the successes
    ok = [r for r in rec["recent"]
          if r["model"] == "doubler" and r["outcome"] == "ok"]
    assert len(ok) == 6
    row = out["models"]["doubler"]
    assert row["qps"] is None  # one sample: no rate
    assert row["error_pct"] == round(100.0 / 7, 2)
    assert row["last_outlier"]["reason"] == "failed"
    assert row["last_outlier"]["outcome"] != "ok"
    assert row["last_outlier"]["seq"] == max(
        o["seq"] for o in rec["outliers"] if o["model"] == "doubler")
    assert out["worker_restarts"] == 0
    # the reference's console reads the port's server alike
    assert jtop.main(["--url", served.http_url, "--once", "--json"]) == 0
    ref = json.loads(capsys.readouterr().out)
    assert ref["models"]["doubler"]["error_pct"] == row["error_pct"]
    assert ref["recorder"]["models"] == rec["models"]


def test_once_renders_the_table(served, capsys):
    _send(served.http_url, 2)
    capsys.readouterr()
    assert ttop.main(["--url", served.http_url, "--once"]) == 0
    text = capsys.readouterr().out
    assert text.startswith(f"triton-top — http://{served.http_url} — ")
    assert "MODEL" in text and "P99ms" in text and "doubler" in text


def test_fleet_view_over_two_urls(served, capsys):
    _send(served.http_url, 1)
    capsys.readouterr()
    url = served.http_url
    assert ttop.main(["--url", url, "--url", "127.0.0.1:1", "--once",
                      "--json", "--timeout", "1"]) == 0
    captured = capsys.readouterr()
    out = json.loads(captured.out)
    assert "cannot poll http://127.0.0.1:1" in captured.err
    assert out["endpoints"]["http://127.0.0.1:1"] is None
    assert out["models"]["doubler"]["error_pct"] is not None


def test_unreachable_server_exits_nonzero(capsys):
    rc = ttop.main(["--url", "127.0.0.1:1", "--once", "--timeout", "0.2"])
    assert rc == 1
    assert "cannot poll" in capsys.readouterr().err
