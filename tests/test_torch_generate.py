"""``llama_decode`` and ``llama_generate`` served by the port against the
reference's server, on the CPU.

Both packages' in-process servers run in this process, in independent and
in batched mode (``TRITON_TPU_DECODE_MODE``), on the tiny ``llama_tpu``
preset in f32 (both presets' dtype set to f32 here) with the reference's
weights (``init_params(PRNGKey(3))``, ``llama_tpu``'s seed) carried to the
port as numpy.  The same requests go to both, and each test holds:

* ``POST .../generate_stream``: the SSE body frame for frame -- the bytes
  equal once each frame's ``logprob`` is set aside, which is held to
  2e-4 (the two packages' f32 sums differ in the last bits) -- and the
  headers;
* ``POST .../generate``: the JSON, byte for byte, of a model that is not
  decoupled, and the 400 of one that is;
* ``llama_generate`` tokens on a gRPC stream (the port's gRPC-Web client
  against both servers' HTTP ports) and ``llama_decode`` driven closed
  loop over HTTP: the same tokens, which are ``llama_generate``'s;
* the parameter errors: status and message;
* sampling: a seed reproduces its tokens, ``top_k = 1`` and a tiny
  ``top_p`` give greedy at any temperature, and unseeded requests vary
  (the port draws from a ``torch.Generator``, so sampled tokens are not
  the reference's: a design difference);
* a traced batched stream's record with its decode ticks, whose
  ``tick_seq`` join the device statistics' tick rows, and the tenant's
  tokens in the cost ledger.
"""

import dataclasses
import json
import re
import socket
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from triton_client_tpu.models import decode as jdec
from triton_client_tpu.models import language as jlang
from triton_client_tpu.models import transformer as jtr
from triton_client_tpu.models import zoo as jzoo
from triton_client_tpu.server.registry import ModelRegistry as JaxRegistry
from triton_client_tpu.server.testing import ServerHarness as JaxHarness
from triton_client_tpu_torch import grpc as tgrpc
from triton_client_tpu_torch import http as thttp
from triton_client_tpu_torch.models import decode as tdec
from triton_client_tpu_torch.models import language as tlang
from triton_client_tpu_torch.models import zoo as tzoo
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import ServerHarness

MODES = ["independent", "batched"]


@pytest.fixture(scope="module", params=MODES)
def servers(request):
    """(mode, port harness, reference harness)."""
    mode = request.param
    with pytest.MonkeyPatch.context() as mp:
        for presets, dtype in ((jlang._LLAMA_PRESETS, jnp.float32),
                               (tlang._LLAMA_PRESETS, torch.float32)):
            mp.setitem(presets, "tiny", dataclasses.replace(
                presets["tiny"], dtype=dtype))
        mp.setenv("TRITON_TPU_LLAMA_PRESET", "tiny")
        mp.setenv("TRITON_TPU_DECODE_MODE", mode)
        mp.setenv("TRITON_TPU_DECODE_SLOTS", "4")
        mp.setenv("TRITON_TPU_PREFILL_CHUNK", "32")
        params = {k: np.asarray(v) for k, v in jtr.init_params(
            jax.random.PRNGKey(3), jlang._LLAMA_PRESETS["tiny"]).items()}
        jreg = JaxRegistry()
        jd = jdec.DecodeModel()
        for m in (jd.model, jdec.make_llama_generate(jd),
                  jzoo.make_simple_string(),
                  jzoo.make_custom_identity_int32()):
            jreg.register_model(m)
        treg = ModelRegistry()
        td = tzoo.make_llama_decode("cpu", params=params)
        for m in (td.model, tdec.make_llama_generate(td),
                  tzoo.make_simple_string(),
                  tzoo.make_custom_identity_int32()):
            treg.register_model(m)
        with JaxHarness(jreg) as jh, ServerHarness(treg) as th:
            yield mode, th, jh


def _post(url, path, body, headers=None):
    req = urllib.request.Request(
        f"http://{url}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    return urllib.request.urlopen(req, timeout=120)


def _status(url, path, body):
    try:
        with _post(url, path, body) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


_FRAME = re.compile(rb"data: (.*?)\n\n", re.S)


def _sse(url, body, model="llama_generate", headers=None):
    """(headers, frames' JSON, raw body) of one generate_stream."""
    with _post(url, f"/v2/models/{model}/generate_stream", body,
               headers) as resp:
        raw = resp.read()
        hdrs = {k.lower(): v for k, v in resp.getheaders()}
    frames = _FRAME.findall(raw)
    assert b"".join(b"data: %s\n\n" % f for f in frames) == raw
    return hdrs, [json.loads(f) for f in frames], raw


def _without_logprob(frames):
    return [json.dumps({k: v for k, v in f.items() if k != "logprob"})
            for f in frames]


@pytest.mark.parametrize("body", [
    {"text_input": "the quick brown fox", "max_tokens": 12},
    {"text_input": "penalized", "max_tokens": 7, "frequency_penalty": 0.8,
     "presence_penalty": -0.5},
    {"text_input": "", "max_tokens": 1},
    {"text_input": "clamped to the cache", "max_tokens": 100000},
], ids=["greedy", "penalties", "one-token", "clamped"])
def test_generate_stream_sse_as_reference(servers, body):
    _mode, th, jh = servers
    t_hdr, t_frames, t_raw = _sse(th.http_url, body)
    j_hdr, j_frames, j_raw = _sse(jh.http_url, body)
    for h in ("content-type", "cache-control"):
        assert t_hdr[h] == j_hdr[h], h
    assert t_hdr["content-type"] == "text/event-stream"
    assert len(t_frames) == len(j_frames) == min(body["max_tokens"], 128)
    assert _without_logprob(t_frames) == _without_logprob(j_frames)
    np.testing.assert_allclose([f["logprob"] for f in t_frames],
                               [f["logprob"] for f in j_frames],
                               rtol=2e-4, atol=2e-4)
    same = [a == b for a, b in zip(t_frames, j_frames)]
    if all(same):
        assert t_raw == j_raw


@pytest.mark.parametrize("model,body", [
    ("simple_string", {"INPUT0": [str(i) for i in range(16)],
                       "INPUT1": ["1"] * 16}),
    ("custom_identity_int32", {"INPUT0": list(range(16)), "tag": "x"}),
])
def test_generate_json_as_reference(servers, model, body):
    _mode, th, jh = servers
    with _post(th.http_url, f"/v2/models/{model}/generate", body) as t, \
            _post(jh.http_url, f"/v2/models/{model}/generate", body) as j:
        assert t.read() == j.read()


@pytest.mark.parametrize("path,body", [
    ("/v2/models/llama_generate/generate", {"text_input": "hi"}),
    ("/v2/models/simple_string/generate", {"INPUT0": ["1"] * 16}),
    ("/v2/models/simple_string/generate", {"INPUT0": ["1"] * 3,
                                           "INPUT1": ["1"] * 16}),
    ("/v2/models/llama_generate/generate_stream", {"text_input": "x",
                                                   "temperature": -1}),
    ("/v2/models/llama_generate/generate_stream", {"text_input": "x",
                                                   "top_k": -1}),
    ("/v2/models/llama_generate/generate_stream", {"text_input": "x",
                                                   "top_k": 100000}),
    ("/v2/models/llama_generate/generate_stream", {"text_input": "x",
                                                   "top_p": 0}),
    ("/v2/models/llama_generate/generate_stream", {"text_input": "x",
                                                   "top_p": 1.5}),
    ("/v2/models/llama_generate/generate_stream",
     {"text_input": "x", "frequency_penalty": 2.5}),
    ("/v2/models/llama_generate/generate_stream",
     {"text_input": "x", "presence_penalty": -3}),
    ("/v2/models/llama_generate/generate_stream", {"text_input": "x",
                                                   "max_tokens": "many"}),
    ("/v2/models/llama_generate/generate_stream", {"text_input": "x",
                                                   "temperature": "hot"}),
    ("/v2/models/llama_generate/generate_stream", {"text_input": ["a"],
                                                   "extra": [1]}),
    ("/v2/models/llama_generate/generate_stream", {"max_tokens": 3}),
    ("/v2/models/nope/generate_stream", {"text_input": "x"}),
], ids=["decoupled-unary", "missing-input", "bad-size", "temperature",
        "top_k-negative", "top_k-large", "top_p-zero", "top_p-large",
        "frequency", "presence", "max_tokens", "temperature-text",
        "list-parameter", "no-prompt", "unknown-model"])
def test_generate_errors_as_reference(servers, path, body):
    _mode, th, jh = servers
    assert _status(th.http_url, path, body) == _status(jh.http_url, path,
                                                       body)


def test_malformed_generate_json_is_400(servers):
    _mode, th, jh = servers
    for url in (th.http_url, jh.http_url):
        req = urllib.request.Request(
            f"http://{url}/v2/models/simple_string/generate", data=b"{x",
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 400


def _grpc_tokens(url, prompt: bytes, n: int, **params):
    """llama_generate's token ids on one gRPC stream of the port's
    client."""
    import queue

    got = queue.Queue()
    c = tgrpc.InferenceServerClient(url)
    c.start_stream(callback=lambda result, error: got.put((result, error)))
    try:
        inp = tgrpc.InferInput("text_input", [1], "BYTES")
        inp.set_data_from_numpy(np.array([prompt], dtype=object))
        c.async_stream_infer("llama_generate", [inp],
                             parameters={"max_tokens": n, **params},
                             enable_empty_final_response=True)
        toks = []
        while True:
            result, error = got.get(timeout=120)
            assert error is None, error
            resp = result.get_response()
            if resp.parameters["triton_final_response"].bool_param:
                break
            toks.append(int(result.as_numpy("token_id")[0]))
        return toks
    finally:
        c.stop_stream()
        c.close()


def _decode_closed_loop(url, seq_id, prompt: bytes, n: int):
    """llama_decode over HTTP: the prompt's window, then n - 1 steps each
    fed the last token."""
    window = np.zeros(128, np.int32)
    b = np.frombuffer(prompt, np.uint8)
    window[128 - len(b):] = b
    out = []
    with thttp.InferenceServerClient(url) as c:
        x = window
        for i in range(n):
            inp = thttp.InferInput("TOKENS", [len(x)], "INT32")
            inp.set_data_from_numpy(x)
            res = c.infer("llama_decode", [inp], sequence_id=seq_id,
                          sequence_start=i == 0, sequence_end=i == n - 1)
            x = res.as_numpy("NEXT_TOKEN").astype(np.int32).reshape(1)
            out.append(int(x[0]))
    return out


def test_grpc_stream_and_closed_loop_as_reference(servers):
    _mode, th, jh = servers
    prompt = b"in a hole in the ground"
    got = _grpc_tokens(th.http_url, prompt, 10)
    assert got == _grpc_tokens(jh.http_url, prompt, 10)
    _h, frames, _raw = _sse(th.http_url, {"text_input": prompt.decode(),
                                          "max_tokens": 10})
    assert got == [f["token_id"] for f in frames]
    loop = _decode_closed_loop(th.http_url, 41, prompt, 10)
    assert loop == _decode_closed_loop(jh.http_url, 41, prompt, 10) == got


def test_sampling(servers):
    """Seeded sampling reproduces, ``top_k = 1`` and a tiny ``top_p`` are
    greedy at any temperature, unseeded requests vary."""
    _mode, th, _jh = servers
    url = th.http_url

    def toks(**params):
        return [f["token_id"] for f in _sse(url, {
            "text_input": "sample me", "max_tokens": 12, **params})[1]]

    greedy = toks()
    a = toks(temperature=1.5, seed=3)
    assert a == toks(temperature=1.5, seed=3)
    assert a == _grpc_tokens(url, b"sample me", 12, temperature=1.5, seed=3)
    assert toks(temperature=1.5, top_p=0.9, top_k=20, seed=5) == \
        toks(temperature=1.5, top_p=0.9, top_k=20, seed=5)
    assert toks(temperature=1.5, top_k=1, seed=7) == greedy
    assert toks(temperature=1.5, top_p=1e-6, seed=7) == greedy
    draws = {tuple(toks(temperature=2.0)) for _ in range(4)}
    assert len(draws) > 1


def test_top_p_keeps_the_nucleus():
    """The nucleus cut keeps the smallest descending prefix whose mass
    reaches top_p: with probabilities .5, .3, .15, .05 and top_p .7, only
    the first two tokens are ever drawn."""
    logits = torch.log(torch.tensor([[0.05, 0.5, 0.15, 0.3]]))
    gen = torch.Generator().manual_seed(0)
    drawn = {int(tdec._sample(logits, gen, 1.0, 0, 0.7)[0])
             for _ in range(200)}
    assert drawn == {1, 3}


def test_traced_stream_joins_ticks_and_charges_tenant(servers, tmp_path):
    """Both servers' stream records carry the same keys; in batched mode
    they list the decode worker's dispatches (in independent mode there
    are none), which join the port's tick rows, and the tenant is charged
    its generated tokens."""
    mode, th, jh = servers
    def tick_rows():
        return th.core.device_stats_snapshot("llama_decode")["ticks"].get(
            "llama_decode", {}).get("256", {"ticks": 0, "steps": 0,
                                             "uploads": 0})

    before = tick_rows()
    records = {}
    for name, h in (("port", th), ("ref", jh)):
        path = tmp_path / f"{name}.json"
        _post(h.http_url, "/v2/trace/setting", {
            "trace_file": [str(path)], "trace_level": ["TIMESTAMPS"],
            "trace_rate": ["1"]}).read()
        _sse(h.http_url, {"text_input": "traced", "max_tokens": 9},
             headers={"triton-tenant": "gold"})
        _post(h.http_url, "/v2/trace/setting",
              {"trace_level": ["OFF"]}).read()
        lines = []
        for _ in range(200):
            if path.exists() and path.read_text().strip():
                lines = path.read_text().splitlines()
                break
            import time
            time.sleep(0.02)
        records[name] = json.loads(lines[-1])
    rec, ref = records["port"], records["ref"]
    assert rec["tokens"] == ref["tokens"] == 9
    assert rec["outcome"] == ref["outcome"]
    assert set(rec) == set(ref) - {"replica"}
    if mode == "independent":
        assert "ticks" not in rec and "ticks" not in ref
        return
    assert {s["name"] for s in rec["spans"]} >= {"SLOT_WAIT", "PREFILL",
                                                 "DECODE"}
    assert set(rec["ticks"][0]) == set(ref["ticks"][0])
    # 8 tokens after the prefill's first, T = 4: two dispatches
    assert [t["steps"] for t in rec["ticks"]] == \
        [t["steps"] for t in ref["ticks"]] == [4, 4]
    rows = tick_rows()
    # the two dispatches of this stream, with no control upload
    assert [rows[k] - before[k] for k in ("ticks", "steps", "uploads")] \
        == [2, 8, 0]
    assert all(rows["first_tick_seq"] <= t["tick_seq"]
               <= rows["last_tick_seq"] for t in rec["ticks"])
    gold = th.core.cost_ledger.snapshot(model="llama_decode")["models"][
        "llama_decode"]["gold"]
    assert gold["tokens"] == 8 and gold["device_us"] > 0


def test_disconnect_cancels_the_generation(servers):
    """A client that closes its connection mid-stream: the stream closes
    and, in batched mode, its slot is freed."""
    mode, th, _jh = servers
    host, port = th.http_url.split(":")
    body = json.dumps({"text_input": "go away", "max_tokens": 120}).encode()
    with socket.create_connection((host, int(port)), timeout=30) as s:
        s.sendall(b"POST /v2/models/llama_generate/generate_stream HTTP/1.1"
                  b"\r\nHost: x\r\nContent-Type: application/json\r\n"
                  b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
        assert s.recv(64).startswith(b"HTTP/1.1 200")
    dec = th.registry.get("llama_decode").decode_model
    if mode == "batched":
        import time
        deadline = time.monotonic() + 60
        while len(dec._free) < 4 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(dec._free) == 4
