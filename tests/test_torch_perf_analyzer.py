"""The port's load generator (``triton_client_tpu_torch.perf_analyzer``)
against the JAX package's (``triton_client_tpu.perf_analyzer``), on the
CPU; mirrors ``tests/test_perf_analyzer.py``.

* Helpers equal to the reference's on the same inputs: the concurrency,
  shape and rate parsers (errors included), ``_make_data`` with seed 0,
  ``_latency_stats`` over a fixed list and ``LatencyHistogram`` quantiles
  (held exactly: the same buckets give the same numbers).
* CLI sweeps at 0.3 s windows, concurrency 1:2, against the port's server
  (``simple``): the port's tool under ``none``, ``system`` and ``cuda``
  (host regions, ``--cuda-shared-memory-device cpu``), the reference's tool
  under ``none`` and ``system``; zero errors, and afterwards no region in
  either status list, in this process or under a key of this process in
  /dev/shm.  One open-loop rate, the ``-f`` CSV headers equal to the
  reference's, and ``--streaming`` without ``-i grpc`` refused as the
  reference refuses it.
* Over a two-replica CPU cluster (``ClusterHarness``): several ``-u``,
  ``--balancing`` and ``--hedge-ms`` each run a sweep on one shared
  ``ClusterClient``, whose per-endpoint counts equal each replica's
  statistics, with the reference's result keys; the cluster refusals
  (``--shared-memory``, ``--streaming``, ``--trace-file``, duplicate
  endpoints, a hedge over one endpoint) with the reference's texts.
"""

import json
import os

import ml_dtypes
import numpy as np
import pytest

from triton_client_tpu import perf_analyzer as jpa
from triton_client_tpu import _telemetry as jtel
import triton_client_tpu.utils.shared_memory as jsys
from triton_client_tpu_torch import perf_analyzer as tpa
from triton_client_tpu_torch import _telemetry as ttel
from triton_client_tpu_torch.models import zoo as tzoo
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import ServerHarness
import triton_client_tpu_torch.utils.cuda_shared_memory as tcuda
import triton_client_tpu_torch.utils.shared_memory as tsys

WINDOW_MS = "300"


@pytest.fixture(scope="module")
def harness():
    registry = ModelRegistry()
    registry.register_model(tzoo.make_simple())
    with ServerHarness(registry) as h:
        yield h


def _no_regions_left(h):
    assert h.core.system_shm.status(None) == {}
    assert h.core.cuda_shm.status(None) == {}
    assert tsys.mapped_shared_memory_regions() == []
    assert tcuda.allocated_shared_memory_regions() == []
    assert jsys.mapped_shared_memory_regions() == []
    assert not [k for k in os.listdir("/dev/shm")
                if k.startswith(f"pa_{os.getpid()}_")]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["1", "1:4", "2:8:2", "1:4:3", "3:1"])
def test_parse_concurrency_range_matches_reference(spec):
    assert tpa._parse_concurrency_range(spec) == \
        jpa._parse_concurrency_range(spec)


@pytest.mark.parametrize("args", [["INPUT0:3,224,224"], ["A:1", "B:2,3"],
                                  ["name:with:colon:4"], ["8"], ["INPUT0"],
                                  ["X:"]])
def test_parse_shapes_matches_reference(args):
    def run(mod):
        try:
            return mod._parse_shapes(args)
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(tpa) == run(jpa)


@pytest.mark.parametrize("spec", ["5", "10:30:10", "2:4", "0.5:2:0.5",
                                  "10:30:0", "0", "-1:2"])
def test_parse_rate_range_matches_reference(spec):
    def run(mod):
        try:
            return mod._parse_rate_range(spec)
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(tpa) == run(jpa)


_SPECS = [
    {"name": "I32", "datatype": "INT32", "shape": [-1, 4]},
    {"name": "F32", "datatype": "FP32", "shape": [-1, 2, 3]},
    {"name": "F16", "datatype": "FP16", "shape": [-1, 5]},
    {"name": "BF", "datatype": "BF16", "shape": [-1, 3]},
    {"name": "B", "datatype": "BOOL", "shape": [-1, 2]},
    {"name": "U8", "datatype": "UINT8", "shape": [-1, 7]},
    {"name": "I64", "datatype": "INT64", "shape": [-1, -1]},
    {"name": "S", "datatype": "BYTES", "shape": [-1, 2]},
]


@pytest.mark.parametrize("batch,max_batch,shapes", [
    (1, 8, {}), (4, 8, {"I64": [6, 2]}), (1, 0, {}),
])
def test_make_data_matches_reference(batch, max_batch, shapes):
    got = tpa._make_data(_SPECS, shapes, batch, max_batch,
                         np.random.default_rng(0), 5)
    want = jpa._make_data(_SPECS, shapes, batch, max_batch,
                          np.random.default_rng(0), 5)
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert got[name].shape == want[name].shape, name
        np.testing.assert_array_equal(got[name], want[name])
    assert got["BF"].dtype == np.dtype(ml_dtypes.bfloat16)


_LATENCIES = [float(x) for x in np.random.default_rng(3).lognormal(
    np.log(2e-3), 0.6, 500)] + [5e-7, 0.0, 200.0]


@pytest.mark.parametrize("extra", [None, 99, 75])
def test_latency_stats_match_reference(extra):
    assert tpa._latency_stats(_LATENCIES, extra) == \
        jpa._latency_stats(_LATENCIES, extra)
    empty_t, empty_j = tpa._latency_stats([]), jpa._latency_stats([])
    assert sorted(empty_t) == sorted(empty_j)
    assert all(np.isnan(v) for v in empty_t.values())


def test_latency_histogram_quantiles_match_reference():
    t, j = ttel.LatencyHistogram(), jtel.LatencyHistogram()
    t2, j2 = ttel.LatencyHistogram(), jtel.LatencyHistogram()
    for i, v in enumerate(_LATENCIES):
        (t if i % 2 else t2).observe(v)
        (j if i % 2 else j2).observe(v)
    t.merge(t2)
    j.merge(j2)
    assert t.NUM_BUCKETS == j.NUM_BUCKETS
    assert t.count == j.count == len(_LATENCIES)
    assert t.mean() == j.mean()
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0):
        assert t.quantile(q) == j.quantile(q), q
    assert t.percentile(99) == j.percentile(99)
    assert np.isnan(ttel.LatencyHistogram().quantile(0.5))


# ---------------------------------------------------------------------------
# sweeps against the port's server
# ---------------------------------------------------------------------------

def _results(out):
    return [json.loads(line.split("result ", 1)[1])
            for line in out.splitlines() if line.startswith("  result ")]


@pytest.mark.parametrize("shm", ["none", "system", "cuda"])
def test_port_tool_sweeps_the_port_server(harness, shm, tmp_path, capsys):
    report = tmp_path / "latency.csv"
    rc = tpa.main(["-m", "simple", "-u", harness.http_url,
                   "--concurrency-range", "1:2",
                   "--measurement-interval", WINDOW_MS,
                   "--shared-memory", shm,
                   "--cuda-shared-memory-device", "cpu", "-v",
                   "-f", str(report)])
    out = capsys.readouterr().out
    assert rc == 0, out
    results = _results(out)
    assert [r["concurrency"] for r in results] == [1, 2]
    for r in results:
        assert r["errors"] == 0 and r["throughput"] > 0, r
        assert r["window_end_s"] - r["window_start_s"] >= 0.3
        assert r["p50_us"] <= r["p99_us"]
    left = [ln for ln in out.splitlines() if ln.startswith("regions left ")]
    assert json.loads(left[0][len("regions left "):]) == {"system": [],
                                                          "cuda": []}
    lines = report.read_text().strip().splitlines()
    assert len(lines) == 3 and lines[1].startswith("1,")
    _no_regions_left(harness)


@pytest.mark.parametrize("shm", ["none", "system"])
def test_reference_tool_sweeps_the_port_server(harness, shm, capsys):
    rc = jpa.main(["-m", "simple", "-u", harness.http_url, "-i", "http",
                   "--concurrency-range", "1:2",
                   "--measurement-interval", WINDOW_MS,
                   "--shared-memory", shm])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.count("Concurrency:") == 2
    assert "errors" not in out, out
    _no_regions_left(harness)


def test_open_loop_rate(harness, tmp_path, capsys):
    report = tmp_path / "rate.csv"
    rc = tpa.main(["-m", "simple", "-u", harness.http_url,
                   "--request-rate-range", "40",
                   "--request-distribution", "poisson",
                   "--measurement-interval", WINDOW_MS, "--max-threads", "2",
                   "-v", "-f", str(report)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "open-loop" in out and "from scheduled send" in out
    (res,) = _results(out)
    assert res["errors"] == 0 and res["request_rate"] == 40, res
    assert res["send_lag_p99_ms"] is not None
    lines = report.read_text().strip().splitlines()
    assert len(lines) == 2 and lines[1].startswith("40,")


def test_csv_headers_match_reference(harness, tmp_path):
    for args in (["--concurrency-range", "1"],
                 ["--request-rate-range", "20", "--max-threads", "1"]):
        heads = []
        for mod in (tpa, jpa):
            report = tmp_path / f"{mod.__name__}.csv"
            assert mod.main(["-m", "simple", "-u", harness.http_url,
                             "--measurement-interval", "100", "-f",
                             str(report), *args]) == 0
            heads.append(report.read_text().splitlines()[0])
        assert heads[0] == heads[1]


@pytest.mark.parametrize("flag,why", [
    # the reference's rule: a stream is a gRPC stream
    (["--streaming"], "--streaming requires -i grpc"),
    # the reference's rules: a stream's answers come on its callback, its
    # metadata is fixed when it opens
    (["-i", "grpc", "--streaming", "--retries", "3"],
     "--retries is not supported with --streaming"),
    # the reference's cluster rules
    (["-u", "a:1", "-u", "a:1"], "duplicate -u endpoints"),
    (["-u", "a:1,b:2", "--shared-memory", "system"],
     "--shared-memory requires a single -u endpoint"),
    (["-u", "a:1", "-u", "b:2", "-i", "grpc", "--streaming"],
     "not supported with multiple -u endpoints"),
    (["-u", "a:1", "-u", "b:2", "--trace-file", "/tmp/t.json"],
     "--trace-file requires a single -u endpoint"),
    (["--hedge-ms", "5"], "--hedge-ms needs at least two -u endpoints"),
    (["-u", "a:1,b:2", "--hedge-ms", "-1"], "--hedge-ms must be >= 0"),
    (["--balancing", "fastest"], "invalid choice"),
    (["-i", "grpc", "--streaming", "--tenant", "t"],
     "--tenant is not supported with --streaming"),
    (["--priority", "high"], "invalid int value"),
    (["--retries", "x"], "invalid int value"),
    # --export-metrics is served now (tests/test_torch_client_telemetry.py);
    # without its PATH it is refused
    (["--export-metrics"], "expected one argument"),
])
def test_flags_not_ported_are_refused(flag, why, capsys):
    with pytest.raises(SystemExit) as err:
        tpa.main(["-m", "simple", *flag])
    assert err.value.code == 2
    assert why in capsys.readouterr().err


@pytest.fixture(scope="module")
def pair():
    """Two replicas of ``simple``."""
    from triton_client_tpu_torch.server.testing import ClusterHarness

    def factory():
        r = ModelRegistry()
        r.register_model(tzoo.make_simple())
        return r

    with ClusterHarness(factory, n=2) as ch:
        yield ch


def _served(ch):
    return [h.core.statistics("simple")[0]["inference_stats"]["success"]
            ["count"] for h in ch.harnesses]


@pytest.mark.parametrize("flags", [
    ["-u", "{0}", "-u", "{1}"],
    ["-u", "{0},{1}", "--balancing", "round_robin"],
    ["-u", "{0}", "-u", "{1}", "--hedge-ms", "50"],
], ids=["several-u", "balancing", "hedge-ms"])
def test_cluster_flags_run_a_sweep(pair, flags, capsys):
    """Each cluster flag sweeps the pair through one shared ClusterClient:
    no error, both replicas served, the run's per-endpoint counts equal to
    each replica's own count, the result carrying ``hedges`` /
    ``hedge_wins`` and their counts over the run (with ``--hedge-ms``,
    replica 1 answers 400 ms late and a hedge past it wins)."""
    from triton_client_tpu_torch.server.chaos import ChaosInjector

    argv = [f.format(*pair.http_urls) for f in flags]
    hedged = "--hedge-ms" in flags
    if hedged:
        pair.chaos(1, ChaosInjector(rate=1.0, kinds=["latency"],
                                    latency_ms=400.0, seed=1))
    before = _served(pair)
    try:
        rc = tpa.main(["-m", "simple", *argv, "--concurrency-range", "2",
                       "--measurement-interval", WINDOW_MS, "-v"])
    finally:
        pair.chaos(1, None)
    out = capsys.readouterr().out
    assert rc == 0, out
    (res,) = _results(out)
    assert res["errors"] == 0 and res["throughput"] > 0, res
    served = [a - b for a, b in zip(_served(pair), before)]
    assert all(n > 0 for n in served), served
    assert [res["endpoints_run"][u] for u in pair.http_urls] == served
    assert sum(res["endpoints"].values()) <= sum(served)
    assert "endpoint distribution: " in out
    policy = "round_robin" if "--balancing" in flags else \
        "least_outstanding"
    assert f"[{policy}" in out
    if hedged:
        # over the run every win counts beside its hedge; the window's
        # counts (the reference's) may hold a win whose hedge was sent
        # before the window opened
        assert 0 < res["hedge_wins_run"] <= res["hedges_run"]
        assert 0 <= res["hedge_wins"] <= res["hedge_wins_run"]
        assert 0 <= res["hedges"] <= res["hedges_run"]
        assert "hedge 50ms" in out
    else:
        assert res["hedges"] == res["hedge_wins"] == 0
        assert res["hedges_run"] == res["hedge_wins_run"] == 0


def test_cluster_result_keys_are_the_reference_s(pair, tmp_path, capsys):
    """The reference's tool over the same pair, and the port's: every key
    of the reference's level result is in the port's."""
    urls = ",".join(pair.http_urls)
    keys = []
    for mod in (tpa, jpa):
        path = tmp_path / f"{mod.__name__}.json"
        assert mod.main(["-m", "simple", "-u", urls,
                         "--concurrency-range", "1",
                         "--measurement-interval", WINDOW_MS,
                         "--export-metrics", str(path)]) == 0
        exported = json.loads(path.read_text())
        assert exported["urls"] == pair.http_urls
        keys.append(set(exported["results"][0]))
    capsys.readouterr()
    assert keys[1] <= keys[0], keys[1] - keys[0]
    assert {"endpoints", "hedges", "hedge_wins"} <= keys[1]


def test_xla_mode_is_dropped(capsys):
    with pytest.raises(SystemExit):
        tpa.main(["-m", "simple", "--shared-memory", "xla"])
    assert "invalid choice" in capsys.readouterr().err


@pytest.mark.parametrize("outputs,batch,max_batch,want", [
    # resnet50 at -b 32: 32 x 1000 x 4 bytes, over the 100 KiB default
    ([{"name": "OUTPUT", "datatype": "FP32", "shape": [-1, 1000]}], 32, 32,
     128000),
    # small fixed outputs keep the default
    ([{"name": "OUTPUT0", "datatype": "INT32", "shape": [1, 16]}], 1, 0,
     102400),
    # the largest of several, BF16 at 2 bytes
    ([{"name": "A", "datatype": "BF16", "shape": [-1, 300, 300]},
      {"name": "B", "datatype": "FP32", "shape": [-1, 10]}], 2, 8, 360000),
    # a dynamic dim or BYTES: the flag sizes it
    ([{"name": "O", "datatype": "FP32", "shape": [-1, -1]},
      {"name": "S", "datatype": "BYTES", "shape": [-1, 4000]}], 64, 64,
     102400),
], ids=["resnet50 -b 32", "simple", "bf16 largest", "dynamic and bytes"])
def test_output_regions_hold_fixed_shape_outputs(outputs, batch, max_batch,
                                                 want):
    assert tpa._output_region_size(outputs, batch, max_batch, 102400) == want
