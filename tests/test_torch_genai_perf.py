"""The port's ``genai_perf`` against the port's server and the reference's,
on the CPU.

The counterpart of ``tests/test_genai_perf.py``.  Both packages'
in-process servers run in this process on the tiny ``llama_tpu`` preset in
f32 with the same weights (as ``tests/test_torch_generate.py``), batched
mode with 4 slots.  The port's tool runs against both: the ``llama_decode``
closed loop over its gRPC-Web client (the reference's HTTP port bridges
gRPC-Web too) and SSE on ``generate_stream``.  Both runs give the same
counts, no error and the same report keys, which are the reference tool's.
No time, rate or ratio is asserted: the suite runs under parallel load.
"""

import dataclasses
import json
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from triton_client_tpu import genai_perf as jgp
from triton_client_tpu.models import decode as jdec
from triton_client_tpu.models import language as jlang
from triton_client_tpu.models import transformer as jtr
from triton_client_tpu.models import zoo as jzoo
from triton_client_tpu.server.registry import ModelRegistry as JaxRegistry
from triton_client_tpu.server.testing import ServerHarness as JaxHarness
from triton_client_tpu_torch import genai_perf
from triton_client_tpu_torch._telemetry import new_trace_context
from triton_client_tpu_torch.models import decode as tdec
from triton_client_tpu_torch.models import language as tlang
from triton_client_tpu_torch.models import zoo as tzoo
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import ServerHarness

PCT_KEYS = {"avg", "min", "max", "p50", "p90", "p99"}


@pytest.fixture(scope="module")
def servers():
    """(port harness, reference harness)."""
    with pytest.MonkeyPatch.context() as mp:
        for presets, dtype in ((jlang._LLAMA_PRESETS, jnp.float32),
                               (tlang._LLAMA_PRESETS, torch.float32)):
            mp.setitem(presets, "tiny", dataclasses.replace(
                presets["tiny"], dtype=dtype))
        mp.setenv("TRITON_TPU_LLAMA_PRESET", "tiny")
        mp.setenv("TRITON_TPU_DECODE_MODE", "batched")
        mp.setenv("TRITON_TPU_DECODE_SLOTS", "4")
        params = {k: np.asarray(v) for k, v in jtr.init_params(
            jax.random.PRNGKey(3), jlang._LLAMA_PRESETS["tiny"]).items()}
        jreg = JaxRegistry()
        jd = jdec.DecodeModel()
        for m in (jd.model, jdec.make_llama_generate(jd),
                  jzoo.make_identity_fp32()):
            jreg.register_model(m)
        treg = ModelRegistry()
        td = tzoo.make_llama_decode("cpu", params=params)
        for m in (td.model, tdec.make_llama_generate(td),
                  tzoo.make_identity_fp32()):
            treg.register_model(m)
        with ServerHarness(treg) as th, JaxHarness(jreg) as jh:
            yield th, jh


def _check_report(report, requests, tokens):
    assert report["errors"] == 0, report.get("first_error")
    assert "first_error" not in report
    assert report["requests_completed"] == requests
    assert report["output_tokens_per_request"] == tokens
    for metric in ("time_to_first_token_ms", "inter_token_latency_ms",
                   "itl_steady_ms", "request_latency_ms"):
        p = report[metric]
        assert set(p) == PCT_KEYS, metric
        assert p["min"] <= p["p50"] <= p["max"]
        assert all(np.isfinite(v) and v >= 0 for v in p.values())
    assert report["output_token_throughput_per_sec"] > 0
    assert report["request_throughput_per_sec"] > 0


def test_profile_decode_stream_on_both_servers(servers):
    """The decode closed loop: 3 steps and the sequence_end step's token,
    4 requests from 2 workers, against both servers alike."""
    reports = [genai_perf.profile(
        h.http_url, "llama_decode", concurrency=2, output_tokens=3,
        num_requests=4, stream_timeout=120.0) for h in servers]
    for r in reports:
        _check_report(r, requests=4, tokens=4)
        assert r["model"] == "llama_decode" and r["concurrency"] == 2
    assert set(reports[0]) == set(reports[1])


def test_profile_generate_on_both_servers(servers):
    reports = [genai_perf.profile_generate(
        h.http_url, "llama_generate", concurrency=2, output_tokens=3,
        num_requests=4, stream_timeout=120.0) for h in servers]
    for r in reports:
        _check_report(r, requests=4, tokens=3)
        assert r["endpoint"] == "generate_stream"
    assert set(reports[0]) == set(reports[1])


def test_report_keys_are_the_reference_tools(servers):
    """The port's tool on the port's server and the reference's tool on
    the reference's server report the same keys and counts."""
    th, jh = servers
    ours = genai_perf.profile(th.http_url, "llama_decode", concurrency=1,
                              output_tokens=2, num_requests=1,
                              stream_timeout=120.0)
    theirs = jgp.profile(jh.grpc_url, "llama_decode", concurrency=1,
                         output_tokens=2, num_requests=1,
                         stream_timeout=120.0)
    assert set(ours) == set(theirs)
    for k in ("requests_completed", "output_tokens_per_request", "errors",
              "concurrency", "model"):
        assert ours[k] == theirs[k], k
    ours = genai_perf.profile_generate(th.http_url, "llama_generate",
                                       output_tokens=2, num_requests=1)
    theirs = jgp.profile_generate(jh.http_url, "llama_generate",
                                  output_tokens=2, num_requests=1)
    assert set(ours) == set(theirs)
    assert ours["requests_completed"] == theirs["requests_completed"] == 1


@pytest.mark.parametrize("which", [0, 1], ids=["port", "ref"])
def test_rejects_non_decode_model(servers, which):
    with pytest.raises(RuntimeError, match="decode-contract"):
        genai_perf.profile(servers[which].http_url, "identity_fp32",
                           concurrency=1, output_tokens=1, num_requests=1)


def test_cli_export(servers, tmp_path, capsys):
    th, _jh = servers
    out = tmp_path / "profile.json"
    rc = genai_perf.main([
        "-m", "llama_decode", "-u", th.http_url, "--concurrency", "1",
        "--output-tokens", "2", "--num-requests", "2",
        "--profile-export-file", str(out)])
    assert rc == 0
    report = json.loads(out.read_text())
    assert report["model"] == "llama_decode"
    assert report["errors"] == 0 and report["requests_completed"] == 2
    printed = capsys.readouterr().out
    assert "Time to first token (ms)" in printed
    assert f"exported: {out}" in printed


def test_cli_generate_endpoint(servers):
    th, _jh = servers
    assert genai_perf.main([
        "-m", "llama_generate", "-u", th.http_url, "--endpoint", "generate",
        "--concurrency", "1", "--output-tokens", "2",
        "--num-requests", "1"]) == 0


def test_cli_fails_on_a_model_that_is_not_decode(servers, capsys):
    th, _jh = servers
    assert genai_perf.main(["-m", "identity_fp32", "-u", th.http_url]) == 1
    assert "decode-contract" in capsys.readouterr().err


def test_generate_requests_carry_trace_context(servers, tmp_path):
    """profile_generate stamps each request with new_trace_context: the
    server's stream record holds its id and traceparent."""
    th, _jh = servers
    path = tmp_path / "trace.json"
    th.core.trace_settings.update({"trace_file": [str(path)],
                                   "trace_level": ["TIMESTAMPS"],
                                   "trace_rate": ["1"]})
    th.core.tracer.settings_updated()
    try:
        report = genai_perf.profile_generate(
            th.http_url, "llama_generate", output_tokens=2, num_requests=2)
    finally:
        th.core.trace_settings.update({"trace_level": ["OFF"]})
        th.core.tracer.settings_updated()
    assert report["errors"] == 0
    import time
    deadline = time.monotonic() + 10
    records = []
    while time.monotonic() < deadline:
        if path.exists():
            records = [json.loads(ln) for ln in path.read_text().splitlines()
                       if ln.strip()]
        if len(records) >= 2:
            break
        time.sleep(0.05)
    assert len(records) == 2
    for rec in records:
        assert re.fullmatch(r"[0-9a-f]{16}", rec["triton_request_id"])
        assert re.fullmatch(r"00-[0-9a-f]{32}-[0-9a-f]{16}-01",
                            rec["traceparent"])
    assert records[0]["traceparent"] != records[1]["traceparent"]


def test_new_trace_context_as_reference():
    from triton_client_tpu._telemetry import new_trace_context as ref

    for rid in ("", "my-id", "bad\nid"):
        ours, theirs = new_trace_context(rid), ref(rid)
        assert set(ours) == set(theirs)
        assert (ours["triton-request-id"] == rid) == \
            (theirs["triton-request-id"] == rid)
        assert len(ours["traceparent"]) == len(theirs["traceparent"])
