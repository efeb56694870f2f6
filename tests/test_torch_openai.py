"""The OpenAI routes (``/v1/models``, ``/v1/completions``,
``/v1/chat/completions``) served by the port against the reference's
server, on the CPU.

The counterpart of ``tests/test_openai_api.py``, class by class.  Both
packages' in-process servers run in this process, in independent and in
batched mode, on the tiny ``llama_tpu`` preset in f32 with the reference's
weights (``init_params(PRNGKey(3))``) carried to the port as numpy, as in
``tests/test_torch_generate.py``.  The same request goes to both:

* a greedy answer, streamed or not, is the reference's once ``id``,
  ``created`` and ``usage.device_time_us`` are masked and each logprob is
  set aside, which is held to 2e-4;
* an SSE body is compared choice by choice (concurrent choices interleave
  differently from run to run in both packages);
* every refused parameter gives the reference's status, message and
  ``type``;
* sampled answers draw from a ``torch.Generator`` and cannot be the
  reference's: a seed reproduces them, and their shape is checked.

Beside them: the tenant header reaches the QoS counters, a stopped stream
frees its decode slot, and ``n`` beyond the slots answers 429 and leaves
every slot free.
"""

import dataclasses
import json
import re
import socket
import time
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
from triton_client_tpu_torch.models import decode as tdec
from triton_client_tpu_torch.models import language as tlang
from triton_client_tpu_torch.models import zoo as tzoo
from triton_client_tpu_torch.server import openai_api
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import ServerHarness

MODES = ["independent", "batched"]
SLOTS = 4
LP_TOL = 2e-4


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
        mp.setenv("TRITON_TPU_DECODE_SLOTS", str(SLOTS))
        params = {k: np.asarray(v) for k, v in jtr.init_params(
            jax.random.PRNGKey(3), jlang._LLAMA_PRESETS["tiny"]).items()}
        jreg = JaxRegistry()
        jd = jdec.DecodeModel()
        for m in (jd.model, jdec.make_llama_generate(jd),
                  jzoo.make_simple_string()):
            jreg.register_model(m)
        treg = ModelRegistry()
        td = tzoo.make_llama_decode("cpu", params=params)
        for m in (td.model, tdec.make_llama_generate(td),
                  tzoo.make_simple_string()):
            treg.register_model(m)
        with JaxHarness(jreg) as jh, ServerHarness(treg) as th:
            yield mode, th, jh


def _post(url, path, body, headers=None):
    req = urllib.request.Request(
        f"http://{url}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    return urllib.request.urlopen(req, timeout=120)


def _call(url, path, body, headers=None):
    """(status, raw body) of one request, an error status included."""
    try:
        with _post(url, path, body, headers) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


_FRAME = re.compile(rb"data: (.*?)\n\n", re.S)


def _frames(raw: bytes):
    """The SSE frames' JSON and whether ``[DONE]`` ended them."""
    frames = _FRAME.findall(raw)
    assert b"".join(b"data: %s\n\n" % f for f in frames) == raw
    done = bool(frames) and frames[-1] == b"[DONE]"
    return [json.loads(f) for f in frames if f != b"[DONE]"], done


def _mask(obj):
    """The body less what differs between two runs: ``id``, ``created``
    and the measured device time."""
    obj = json.loads(json.dumps(obj))
    obj.pop("id", None)
    obj.pop("created", None)
    if isinstance(obj.get("usage"), dict):
        obj["usage"].pop("device_time_us", None)
    return obj


def _split_lps(obj):
    """(the object with every logprob value replaced by 0, the values in
    order)."""
    values = []

    def walk(x):
        if isinstance(x, dict):
            out = {}
            for k, v in x.items():
                if k in ("token_logprobs",) and isinstance(v, list):
                    values.extend(v)
                    out[k] = [0] * len(v)
                elif k == "logprob" and isinstance(v, float):
                    values.append(v)
                    out[k] = 0
                else:
                    out[k] = walk(v)
            return out
        if isinstance(x, list):
            return [walk(v) for v in x]
        return x

    return walk(x=obj), values


def _same(port_obj, ref_obj):
    """Equal once masked, each logprob within LP_TOL."""
    p, p_lps = _split_lps(_mask(port_obj))
    r, r_lps = _split_lps(_mask(ref_obj))
    assert p == r
    np.testing.assert_allclose(p_lps, r_lps, rtol=LP_TOL, atol=LP_TOL)


def _by_choice(frames):
    """Each choice's frames in order, and the frames with no choice (the
    usage chunk)."""
    out, rest = {}, []
    for f in frames:
        if f["choices"]:
            out.setdefault(f["choices"][0]["index"], []).append(_mask(f))
        else:
            rest.append(_mask(f))
    return out, rest


def _both(servers, path, body, headers=None):
    _mode, th, jh = servers
    return (_call(th.http_url, path, body, headers),
            _call(jh.http_url, path, body, headers))


def _same_json(servers, path, body):
    (ts, tb), (js, jb) = _both(servers, path, body)
    assert ts == js == 200, (tb, jb)
    _same(json.loads(tb), json.loads(jb))
    return json.loads(tb)


def _same_stream(servers, path, body):
    (ts, tb), (js, jb) = _both(servers, path, body)
    assert ts == js == 200, (tb, jb)
    t_frames, t_done = _frames(tb)
    j_frames, j_done = _frames(jb)
    assert t_done and j_done
    t_choices, t_rest = _by_choice(t_frames)
    j_choices, j_rest = _by_choice(j_frames)
    assert sorted(t_choices) == sorted(j_choices)
    for i in t_choices:
        assert len(t_choices[i]) == len(j_choices[i]), i
        for a, b in zip(t_choices[i], j_choices[i]):
            _same(a, b)
    assert len(t_rest) == len(j_rest)
    for a, b in zip(t_rest, j_rest):
        _same(a, b)
    return t_frames


def _same_error(servers, path, body):
    (ts, tb), (js, jb) = _both(servers, path, body)
    assert ts == js, (body, tb, jb)
    assert ts >= 400
    assert json.loads(tb) == json.loads(jb), body
    return ts, json.loads(tb)


def _text(url, body, path="/v1/completions"):
    with _post(url, path, body) as r:
        return json.loads(r.read())["choices"][0]["text"]


CHAT = [{"role": "user", "content": "hi"}]


class TestModels:
    def test_lists_generate_capable_models(self, servers):
        _mode, th, jh = servers
        bodies = []
        for url in (th.http_url, jh.http_url):
            with urllib.request.urlopen(f"http://{url}/v1/models",
                                        timeout=30) as r:
                bodies.append(json.loads(r.read()))
        assert bodies[0] == bodies[1]
        ids = [m["id"] for m in bodies[0]["data"]]
        assert ids == ["llama_generate"]


class TestCompletions:
    def test_non_streaming_completion(self, servers):
        out = _same_json(servers, "/v1/completions", {
            "model": "llama_generate", "prompt": "In a hole",
            "max_tokens": 4})
        assert out["object"] == "text_completion"
        assert out["choices"][0]["finish_reason"] == "length"
        assert out["usage"]["completion_tokens"] == 4

    def test_chat_completion(self, servers):
        out = _same_json(servers, "/v1/chat/completions", {
            "model": "llama_generate", "messages": CHAT, "max_tokens": 3})
        assert out["object"] == "chat.completion"
        assert out["choices"][0]["message"]["role"] == "assistant"

    def test_chat_streaming(self, servers):
        frames = _same_stream(servers, "/v1/chat/completions", {
            "model": "llama_generate", "messages": CHAT, "max_tokens": 3,
            "stream": True})
        deltas = [f["choices"][0]["delta"].get("content") for f in frames]
        assert sum(1 for d in deltas if d) == 3
        assert frames[-1]["choices"][0]["finish_reason"] == "length"
        assert frames[0]["object"] == "chat.completion.chunk"

    def test_chat_streaming_sampled_reproduces(self, servers):
        _mode, th, _jh = servers
        body = {"model": "llama_generate", "messages": CHAT,
                "max_tokens": 3, "stream": True, "temperature": 1.0,
                "seed": 4}
        runs = []
        for _ in range(2):
            status, raw = _call(th.http_url, "/v1/chat/completions", body)
            assert status == 200
            frames, done = _frames(raw)
            assert done
            runs.append([f["choices"][0]["delta"].get("content")
                         for f in frames])
        assert runs[0] == runs[1]
        assert sum(1 for d in runs[0] if d) == 3

    def test_deterministic_with_seed(self, servers):
        _mode, th, _jh = servers
        body = {"model": "llama_generate", "prompt": "x", "max_tokens": 6,
                "temperature": 2.0, "seed": 11}
        assert _text(th.http_url, body) == _text(th.http_url, body)

    @pytest.mark.parametrize("path,body", [
        ("/v1/completions", {"prompt": "x"}),
        ("/v1/completions", {"model": "nope", "prompt": "x"}),
        ("/v1/completions", {"model": "simple_string", "prompt": "x"}),
        ("/v1/chat/completions", {"model": "llama_generate",
                                  "messages": "hi"}),
        ("/v1/completions", {"model": "llama_generate", "prompt": 7}),
    ], ids=["no-model", "unknown", "not-generate", "messages", "prompt"])
    def test_errors_are_openai_shaped_400s(self, servers, path, body):
        status, _ = _same_error(servers, path, body)
        assert status == 400

    def test_malformed_json_is_400(self, servers):
        _mode, th, jh = servers
        out = []
        for url in (th.http_url, jh.http_url):
            req = urllib.request.Request(
                f"http://{url}/v1/completions", data=b"{x",
                headers={"Content-Type": "application/json"})
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=60)
            out.append((e.value.code, json.loads(e.value.read())))
        assert out[0] == out[1]


def _greedy_text(url, max_tokens=8):
    return _text(url, {"model": "llama_generate", "prompt": "In a hole",
                       "max_tokens": max_tokens})


class TestStopSequences:
    def test_stop_truncates_non_streaming(self, servers):
        _mode, th, _jh = servers
        base = _greedy_text(th.http_url)
        stop = base[3:5]
        out = _same_json(servers, "/v1/completions", {
            "model": "llama_generate", "prompt": "In a hole",
            "max_tokens": 8, "stop": stop})
        choice = out["choices"][0]
        assert choice["finish_reason"] == "stop"
        assert choice["text"] == base[:base.find(stop)]
        assert out["usage"]["completion_tokens"] <= 8

    def test_stop_mid_generation_streaming(self, servers):
        _mode, th, _jh = servers
        base = _greedy_text(th.http_url)
        stop = base[3:5]
        frames = _same_stream(servers, "/v1/completions", {
            "model": "llama_generate", "prompt": "In a hole",
            "max_tokens": 8, "stop": stop, "stream": True})
        text = "".join(f["choices"][0].get("text") or "" for f in frames
                       if f["choices"][0]["finish_reason"] is None)
        assert text == base[:base.find(stop)]
        assert frames[-1]["choices"][0]["finish_reason"] == "stop"

    def test_unmatched_stop_finishes_length(self, servers):
        _mode, th, _jh = servers
        base = _greedy_text(th.http_url, max_tokens=4)
        out = _same_json(servers, "/v1/completions", {
            "model": "llama_generate", "prompt": "In a hole",
            "max_tokens": 4, "stop": "\x00\x01never\x02"})
        assert out["choices"][0]["text"] == base
        assert out["choices"][0]["finish_reason"] == "length"

    def test_chat_stop(self, servers):
        out = _same_json(servers, "/v1/chat/completions", {
            "model": "llama_generate", "messages": CHAT, "max_tokens": 6,
            "stop": ["X", "Y", "Z", "W"]})
        content = out["choices"][0]["message"]["content"]
        assert not any(s in content for s in "XYZW")

    def test_stopped_stream_frees_its_slot(self, servers):
        """A stop that matches early closes the choice's stream on its
        thread: in batched mode its slot is free again at once."""
        mode, th, _jh = servers
        base = _greedy_text(th.http_url, max_tokens=4)
        status, raw = _call(th.http_url, "/v1/completions", {
            "model": "llama_generate", "prompt": "In a hole",
            "max_tokens": 120, "stop": base[1:3], "stream": True})
        assert status == 200
        frames, done = _frames(raw)
        assert done and frames[-1]["choices"][0]["finish_reason"] == "stop"
        if mode == "batched":
            dec = th.registry.get("llama_decode").decode_model
            deadline = time.monotonic() + 10
            while len(dec._free) < SLOTS and time.monotonic() < deadline:
                time.sleep(0.02)
            assert len(dec._free) == SLOTS


class TestNChoices:
    def test_n2_greedy_non_streaming(self, servers):
        out = _same_json(servers, "/v1/completions", {
            "model": "llama_generate", "prompt": "x", "max_tokens": 4,
            "n": 2})
        assert [c["index"] for c in out["choices"]] == [0, 1]
        assert out["choices"][0]["text"] == out["choices"][1]["text"]
        assert out["usage"]["completion_tokens"] == 8

    def test_n2_seeded_is_reproducible(self, servers):
        _mode, th, _jh = servers

        def run():
            with _post(th.http_url, "/v1/completions", {
                    "model": "llama_generate", "prompt": "x",
                    "max_tokens": 4, "n": 2, "temperature": 1.5,
                    "seed": 7}) as r:
                out = json.loads(r.read())
            assert out["usage"]["completion_tokens"] == 8
            return [c["text"] for c in out["choices"]]

        assert run() == run()

    def test_n2_streaming_interleaves_indices(self, servers):
        frames = _same_stream(servers, "/v1/chat/completions", {
            "model": "llama_generate", "messages": CHAT, "max_tokens": 3,
            "n": 2, "stream": True})
        finishes = {f["choices"][0]["index"]: f["choices"][0]["finish_reason"]
                    for f in frames if f["choices"][0]["finish_reason"]}
        assert finishes == {0: "length", 1: "length"}

    def test_n_beyond_the_slots_is_429_and_frees_them(self, servers):
        """More choices than decode slots: in batched mode the choices
        beyond them are refused (429) and the first failure cancels the
        rest; then every slot is free and a cohort of SLOTS choices is
        admitted.  Independent mode has no slots and answers them all."""
        mode, th, _jh = servers
        body = {"model": "llama_generate", "prompt": "x", "max_tokens": 120,
                "n": SLOTS + 2}
        status, raw = _call(th.http_url, "/v1/completions", body)
        if mode == "independent":
            # no slots: the choices run one after another, all of them
            assert status == 200, raw
            assert len(json.loads(raw)["choices"]) == SLOTS + 2
            return
        assert status == 429, raw
        err = json.loads(raw)["error"]
        assert err["type"] == "invalid_request_error"
        dec = th.registry.get("llama_decode").decode_model
        deadline = time.monotonic() + 10
        while len(dec._free) < SLOTS and time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(dec._free) == SLOTS
        status, raw = _call(th.http_url, "/v1/completions",
                            {**body, "n": SLOTS, "max_tokens": 4})
        assert status == 200, raw
        assert len(json.loads(raw)["choices"]) == SLOTS


class TestCompatEdges:
    def test_openai_error_shape(self, servers):
        _status, err = _same_error(servers, "/v1/completions",
                                   {"model": "nope", "prompt": "x"})
        assert err["error"]["type"] == "invalid_request_error"

    @pytest.mark.parametrize("extra", [
        {"max_tokens": "abc"}, {"temperature": "hot"}, {"seed": [1]},
        {"top_k": {}}, {"top_p": 1.5}, {"frequency_penalty": 2.5},
        {"presence_penalty": -2.5}, {"frequency_penalty": "big"},
        {"n": 0}, {"n": 99}, {"n": "two"}, {"stop": ""},
        {"stop": ["a", "b", "c", "d", "e"]}, {"stop": [7]},
        {"logprobs": 5}, {"logprobs": "yes"},
        {"best_of": 2, "n": 3}, {"best_of": 99}, {"best_of": "many"},
        {"best_of": 3, "stream": True},
        {"echo": True, "logprobs": True},
        {"stream_options": {"include_usage": True}},
        {"stream": True, "stream_options": {"weird": 1}},
        {"stream": True, "stream_options": "yes"},
        {"stream": True, "stream_options": {"include_usage": "yes"}},
        {"priority": -1}, {"priority": "high"}, {"priority": True},
        {"priority": 1.5},
    ])
    def test_rejected_values_as_reference(self, servers, extra):
        status, _ = _same_error(servers, "/v1/completions", {
            "model": "llama_generate", "prompt": "x", "max_tokens": 2,
            **extra})
        assert status == 400

    def test_top_p_without_temperature_samples(self, servers):
        _mode, th, _jh = servers
        outs = {_text(th.http_url, {"model": "llama_generate",
                                    "prompt": "x", "max_tokens": 4,
                                    "top_p": 0.95, "seed": seed})
                for seed in range(6)}
        assert len(outs) > 1

    def test_top_p_sampling_reproduces(self, servers):
        _mode, th, _jh = servers
        body = {"model": "llama_generate", "prompt": "x", "max_tokens": 6,
                "temperature": 1.5, "top_p": 0.9, "seed": 5}
        assert _text(th.http_url, body) == _text(th.http_url, body)

    def test_logprobs_non_streaming(self, servers):
        out = _same_json(servers, "/v1/completions", {
            "model": "llama_generate", "prompt": "lp", "max_tokens": 4,
            "logprobs": True})
        lp = out["choices"][0]["logprobs"]
        assert lp["tokens"] == list(out["choices"][0]["text"])
        assert all(v <= 0.0 for v in lp["token_logprobs"])
        out = _same_json(servers, "/v1/chat/completions", {
            "model": "llama_generate",
            "messages": [{"role": "user", "content": "lp"}],
            "max_tokens": 3, "logprobs": True})
        content = out["choices"][0]["logprobs"]["content"]
        assert len(content) == len(out["choices"][0]["message"]["content"])
        assert all(e["top_logprobs"] == [] and "bytes" in e
                   for e in content)

    def test_chat_top_logprobs_refused(self, servers):
        _same_error(servers, "/v1/chat/completions", {
            "model": "llama_generate", "messages": CHAT, "top_logprobs": 3})

    def test_content_parts_array(self, servers):
        _same_json(servers, "/v1/chat/completions", {
            "model": "llama_generate",
            "messages": [{"role": "user", "content": [
                {"type": "text", "text": "hel"},
                {"type": "text", "text": "lo"}]}],
            "max_tokens": 2})
        _same_error(servers, "/v1/chat/completions", {
            "model": "llama_generate",
            "messages": [{"role": "user", "content": [
                {"type": "image_url", "image_url": {"url": "x"}}]}]})


class TestPenalties:
    @pytest.mark.parametrize("extra", [
        {}, {"frequency_penalty": 2.0},
        {"frequency_penalty": -2.0, "presence_penalty": -2.0},
        {"presence_penalty": 2.0}])
    def test_penalties_as_reference(self, servers, extra):
        _same_json(servers, "/v1/completions", {
            "model": "llama_generate", "prompt": "repeat repeat repeat",
            "max_tokens": 12, **extra})

    def test_penalties_have_effect(self, servers):
        _mode, th, _jh = servers

        def text(**extra):
            return _text(th.http_url, {"model": "llama_generate",
                                       "prompt": "repeat repeat repeat",
                                       "max_tokens": 12, **extra})

        base, push = text(), text(frequency_penalty=2.0)
        pull = text(frequency_penalty=-2.0, presence_penalty=-2.0)
        assert not (base == push == pull)
        a = text(frequency_penalty=1.5, temperature=1.0, seed=3)
        assert a == text(frequency_penalty=1.5, temperature=1.0, seed=3)


class TestBestOf:
    def test_best_of_returns_n_best_by_logprob(self, servers):
        _mode, th, _jh = servers
        with _post(th.http_url, "/v1/completions", {
                "model": "llama_generate", "prompt": "pick",
                "max_tokens": 6, "temperature": 1.2, "seed": 9, "n": 2,
                "best_of": 5, "logprobs": True}) as r:
            out = json.loads(r.read())
        assert [c["index"] for c in out["choices"]] == [0, 1]

        def mean_lp(c):
            lps = c["logprobs"]["token_logprobs"]
            return sum(lps) / len(lps)

        assert mean_lp(out["choices"][0]) >= mean_lp(out["choices"][1])
        assert out["usage"]["completion_tokens"] == 5 * 6

    def test_best_of_greedy_as_reference(self, servers):
        out = _same_json(servers, "/v1/completions", {
            "model": "llama_generate", "prompt": "pick", "max_tokens": 4,
            "n": 1, "best_of": 3})
        assert out["usage"]["completion_tokens"] == 12

    def test_best_of_equal_n_streams(self, servers):
        _same_stream(servers, "/v1/completions", {
            "model": "llama_generate", "prompt": "x", "max_tokens": 2,
            "best_of": 1, "stream": True})


class TestEcho:
    def test_echo_prepends_prompt(self, servers):
        out = _same_json(servers, "/v1/completions", {
            "model": "llama_generate", "prompt": "echo me", "max_tokens": 3,
            "echo": True})
        assert out["choices"][0]["text"].startswith("echo me")

    def test_echo_streaming_prompt_leads(self, servers):
        frames = _same_stream(servers, "/v1/completions", {
            "model": "llama_generate", "prompt": "lead", "max_tokens": 2,
            "echo": True, "stream": True})
        assert frames[0]["choices"][0]["text"] == "lead"


class TestStreamingLogprobs:
    def test_chunks_carry_aligned_logprobs(self, servers):
        frames = _same_stream(servers, "/v1/completions", {
            "model": "llama_generate", "prompt": "slp", "max_tokens": 5,
            "logprobs": True, "stream": True})
        text, tokens, offsets = "", [], []
        for f in frames:
            c = f["choices"][0]
            text += c.get("text") or ""
            if c.get("logprobs"):
                tokens += c["logprobs"]["tokens"]
                offsets += c["logprobs"]["text_offset"]
        assert tokens == list(text)
        assert offsets == list(range(len(text)))

    def test_chat_streaming_logprob_shape(self, servers):
        _same_stream(servers, "/v1/chat/completions", {
            "model": "llama_generate",
            "messages": [{"role": "user", "content": "slp"}],
            "max_tokens": 3, "logprobs": True, "stream": True})

    def test_stop_holds_back_text_but_logprobs_stay_aligned(self, servers):
        _mode, th, _jh = servers
        base = _greedy_text(th.http_url, 10)
        stop = base[4:7]
        frames = _same_stream(servers, "/v1/completions", {
            "model": "llama_generate", "prompt": "In a hole",
            "max_tokens": 10, "logprobs": True, "stream": True,
            "stop": stop})
        text, tokens = "", []
        for f in frames:
            c = f["choices"][0]
            text += c.get("text") or ""
            if c.get("logprobs"):
                tokens += c["logprobs"]["tokens"]
        assert text == base[:base.find(stop)]
        assert tokens == list(text)


class TestParameterSurfaceComplete:
    REJECTED_COMPLETIONS = {
        "logit_bias": {"50256": -100},
        "suffix": " and done",
    }
    REJECTED_CHAT = {
        "logit_bias": {"50256": -100},
        "top_logprobs": 2,
        "response_format": {"type": "json_object"},
        "tools": [{"type": "function", "function": {"name": "f"}}],
        "tool_choice": "auto",
        "functions": [{"name": "f"}],
        "function_call": "auto",
        "parallel_tool_calls": True,
        "store": True,
        "metadata": {"k": "v"},
        "service_tier": "auto",
        "prediction": {"type": "content", "content": "x"},
        "audio": {"voice": "alloy", "format": "wav"},
        "modalities": ["text", "audio"],
        "reasoning_effort": "high",
        "best_of": 2,
        "echo": True,
        "suffix": "s",
    }

    @pytest.mark.parametrize("key", sorted(REJECTED_COMPLETIONS))
    def test_rejected_completions_params(self, servers, key):
        _status, err = _same_error(servers, "/v1/completions", {
            "model": "llama_generate", "prompt": "x",
            key: self.REJECTED_COMPLETIONS[key]})
        assert key in err["error"]["message"]

    @pytest.mark.parametrize("key", sorted(REJECTED_CHAT))
    def test_rejected_chat_params(self, servers, key):
        _status, err = _same_error(servers, "/v1/chat/completions", {
            "model": "llama_generate", "messages": CHAT,
            key: self.REJECTED_CHAT[key]})
        assert key in err["error"]["message"]

    def test_user_and_max_completion_tokens_honored(self, servers):
        out = _same_json(servers, "/v1/chat/completions", {
            "model": "llama_generate", "messages": CHAT,
            "max_completion_tokens": 3, "user": "tester"})
        assert out["usage"]["completion_tokens"] == 3


class TestStreamOptions:
    def test_include_usage_final_chunk(self, servers):
        frames = _same_stream(servers, "/v1/chat/completions", {
            "model": "llama_generate", "messages": CHAT, "max_tokens": 3,
            "stream": True, "n": 2,
            "stream_options": {"include_usage": True}})
        assert all("usage" in f and f["usage"] is None for f in frames[:-1])
        final = frames[-1]
        assert final["choices"] == []
        assert final["usage"]["completion_tokens"] == 6
        assert final["usage"]["total_tokens"] == (
            final["usage"]["prompt_tokens"] + 6)

    def test_without_option_no_usage_fields(self, servers):
        frames = _same_stream(servers, "/v1/completions", {
            "model": "llama_generate", "prompt": "x", "max_tokens": 2,
            "stream": True})
        assert all("usage" not in f for f in frames)


class TestQosIdentity:
    def test_tenant_header_reaches_qos_counters(self, servers):
        _mode, th, jh = servers
        counts = []
        for h in (th, jh):
            before = h.core.qos.tenant_request_counts()
            with _post(h.http_url, "/v1/completions", {
                    "model": "llama_generate", "prompt": "x",
                    "max_tokens": 2, "priority": 2, "n": 2},
                    headers={"triton-tenant": "oai-tenant"}) as r:
                assert len(json.loads(r.read())["choices"]) == 2
            after = h.core.qos.tenant_request_counts()
            key = ("oai-tenant", h.core.qos.tier_of(2))
            counts.append(after.get(key, 0) - before.get(key, 0))
        assert counts == [2, 2]

    def test_anonymous_default(self, servers):
        _mode, th, _jh = servers
        before = th.core.qos.tenant_request_counts().get(("anonymous", 0), 0)
        _text(th.http_url, {"model": "llama_generate", "prompt": "x",
                            "max_tokens": 2})
        assert th.core.qos.tenant_request_counts().get(
            ("anonymous", 0), 0) == before + 1


def test_disconnect_closes_every_choice(servers):
    """A client that goes away mid-stream: every choice's stream closes
    (in batched mode every slot is free again)."""
    mode, th, _jh = servers
    host, port = th.http_url.split(":")
    body = json.dumps({"model": "llama_generate", "prompt": "go away",
                       "max_tokens": 120, "n": 2, "stream": True}).encode()
    with socket.create_connection((host, int(port)), timeout=30) as s:
        s.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Type: application/json\r\n"
                  b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
        assert s.recv(64).startswith(b"HTTP/1.1 200")
    if mode == "batched":
        dec = th.registry.get("llama_decode").decode_model
        deadline = time.monotonic() + 30
        while len(dec._free) < SLOTS and time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(dec._free) == SLOTS


def test_stop_scanner_as_reference():
    """The scanner holds back text, latches on a stop and counts every
    token, piece for piece as the reference's."""
    from triton_client_tpu.server import openai_api as jopenai

    rng = np.random.default_rng(0)
    pieces = [chr(int(c)) for c in rng.integers(97, 100, 64)]
    for stops in ([], ["ab"], ["cc", "aba"], ["b", "ca", "abc", "bb"]):
        ours, ref = (openai_api._StopScanner(stops),
                     jopenai._StopScanner(stops))
        for k, p in enumerate(pieces):
            assert ours.feed(p, -k / 10) == ref.feed(p, -k / 10)
            assert ours.stopped == ref.stopped
            if ours.stopped:
                break
        assert ours.flush() == ref.flush()
        assert ours.tokens == ref.tokens
