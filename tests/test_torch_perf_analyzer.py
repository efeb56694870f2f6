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
  reference's, the reference's flags the port does not take yet refused
  with the ROADMAP item that brings them, and ``--streaming`` without
  ``-i grpc`` refused as the reference refuses it.
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
    (["-u", "a:1", "-u", "b:2"], "ROADMAP A6"),
    (["--balancing", "round_robin"], "ROADMAP A6"),
    (["--hedge-ms", "5"], "ROADMAP A6"),
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
