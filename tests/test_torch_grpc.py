"""The port's gRPC (gRPC-Web on its HTTP port) against the JAX package's,
on the CPU.

Both packages' in-process servers serve ``simple``, the tiny
``longctx_tpu`` (the reference's seed-11 weights carried to the port as
numpy arrays), the tiny ``moe_tpu`` (seed 17) and ``ensemble_llama`` over
the tiny ``llama_tpu`` (seed 3);
the JAX package's HTTP port carries its gRPC-Web bridge.  The port's gRPC
client (``triton_client_tpu_torch.grpc``):

* gets the same answers from both servers, unary and on a stream --
  ``simple`` exactly, ``longctx_tpu`` within 5e-2 (the bf16 logit bound of
  test_torch_transformer.py), ``moe_tpu``'s NEXT_LOGIT within 5e-2 and
  NEXT_TOKEN equal (as test_torch_models.py holds them over HTTP),
  ``ensemble_llama``'s OUT_TEXT and NEXT_TOKEN exactly (as
  test_torch_ensemble.py holds them); the same model metadata
  and config ``as_json`` (the platform aside; ``ensemble_llama``'s config
  whole), shared-memory status lists, statuses and error texts (unary and
  in-band on the stream), and UNIMPLEMENTED where the port names the
  ROADMAP item;
* gets, from the port's server, the answers of the port's HTTP client to
  the same requests, over system and CUDA shared memory (``device="cpu"``
  regions) too, with no region left after;
* gets ``get_response(as_json=True)`` equal to the reference's gRPC
  client's (``MessageToDict``) for the same request.

Decoupled models (``repeat_int32``, ``square_int32``) on a stream: both
servers give the same N responses per request, each flagged
``triton_final_response`` false, and the empty final response (flagged
true) only where the request sets ``triton_enable_empty_final_response``;
a unary request to one, over HTTP or gRPC, is refused with the reference's
status and text.

Beside: the stream keeps the order of its requests and ``stop_stream``
waits for every answer (``cancel_requests`` gives one CANCELLED); requests
with a ``sequence_id`` bypass the dynamic batcher while an ensemble's
member still batches them; the statistics over HTTP and gRPC equal the
reference's counts for the same executions; ``async_infer``; the prepared
request byte for byte the slow path's; a chunked HTTP request body; and
``perf_analyzer -i grpc [--streaming]`` on ``simple``.
"""

import http.client
import json
import os
import queue
import threading
import time
import uuid

import numpy as np
import pytest

import jax

from triton_client_tpu import grpc as jgrpc
from triton_client_tpu.models import language as jlang
from triton_client_tpu.models import transformer as jtr
from triton_client_tpu.models import zoo as jzoo
from triton_client_tpu.server.registry import ModelRegistry as JaxRegistry
from triton_client_tpu.server.testing import ServerHarness as JaxHarness
from triton_client_tpu_torch import grpc as tgrpc
from triton_client_tpu_torch import http as thttp
from triton_client_tpu_torch import perf_analyzer as tpa
from triton_client_tpu_torch.grpc import _transport
from triton_client_tpu_torch.grpc._utils import get_inference_request
from triton_client_tpu_torch.protocol.grpc_web import encode_frame
from triton_client_tpu_torch.models import language as tlang
from triton_client_tpu_torch.models import zoo as tzoo
from triton_client_tpu_torch.protocol import inference as tp
from triton_client_tpu_torch.server.model import TorchModel, make_config
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import ServerHarness
from triton_client_tpu_torch.utils import InferenceServerException
import triton_client_tpu_torch.utils.cuda_shared_memory as tcuda
import triton_client_tpu_torch.utils.shared_memory as tsys

S = 512  # the tiny longctx_tpu preset's window
TEXTS = [b"the quick brown fox", "h\xe9llo".encode(), b"", b"x" * 300]


def _seq_model():
    """A batched model whose executions the tests count."""
    cfg = make_config("seqm", inputs=[("X", "INT32", [4])],
                      outputs=[("Y", "INT32", [4])], max_batch_size=8,
                      preferred_batch_sizes=[8], max_queue_delay_us=200_000,
                      instance_kind="KIND_CPU")
    return TorchModel(cfg, lambda X: {"Y": X * 2})


@pytest.fixture(scope="module")
def servers():
    jreg = JaxRegistry()
    for m in (jzoo.make_simple(), jzoo.make_repeat_int32(),
              jzoo.make_square_int32(), jlang.make_longctx_tpu(),
              jlang.make_moe_tpu(),
              jlang.make_llama_preprocess(), jlang.make_llama_tpu(),
              jlang.make_llama_postprocess(), jlang.make_ensemble_llama()):
        jreg.register_model(m)
    longctx = {k: np.asarray(v) for k, v in jtr.init_params(
        jax.random.PRNGKey(11), jlang.longctx_cfg()).items()}
    moe = {k: np.asarray(v) for k, v in jtr.init_params(
        jax.random.PRNGKey(17), jlang.moe_cfg()).items()}
    llama = {k: np.asarray(v) for k, v in jtr.init_params(
        jax.random.PRNGKey(3), jlang._llama_cfg()).items()}
    treg = ModelRegistry()
    for m in (tzoo.make_simple(), tzoo.make_repeat_int32(),
              tzoo.make_square_int32(),
              tlang.make_longctx_tpu("cpu", params=longctx),
              tlang.make_moe_tpu("cpu", params=moe),
              tlang.make_llama_preprocess(),
              tlang.make_llama_tpu("cpu", params=llama),
              tlang.make_llama_postprocess(), tlang.make_ensemble_llama(),
              _seq_model()):
        treg.register_model(m)
    with JaxHarness(jreg) as jh, ServerHarness(treg) as th:
        yield jh, th


def _both(servers):
    """(port server's url, the reference's HTTP url: its gRPC-Web bridge)."""
    jh, th = servers
    return th.http_url, jh.http_url


def _ab(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-1000, 1000, (1, 16)).astype(np.int32),
            rng.integers(-1000, 1000, (1, 16)).astype(np.int32))


def _inputs(mod, arrays):
    """``mod``'s InferInputs of (name, datatype, array)."""
    out = []
    for name, dt, arr in arrays:
        x = mod.InferInput(name, list(arr.shape), dt)
        x.set_data_from_numpy(arr)
        out.append(x)
    return out


def _simple(a, b):
    return [("INPUT0", "INT32", a), ("INPUT1", "INT32", b)]


def _infer(url, model, arrays, outputs, stream=False):
    """The port's gRPC client's answer, unary or on a stream."""
    with tgrpc.InferenceServerClient(url) as c:
        ins = _inputs(tgrpc, arrays)
        outs = [tgrpc.InferRequestedOutput(o) for o in outputs]
        if not stream:
            res = c.infer(model, ins, outputs=outs)
        else:
            q = queue.Queue()
            c.start_stream(lambda result, error: q.put((result, error)))
            c.async_stream_infer(model, ins, outputs=outs)
            res, err = q.get(timeout=120)
            c.stop_stream()
            assert err is None, err
        return {o: res.as_numpy(o) for o in outputs}


def _err(fn):
    """(status, message) of the InferenceServerException ``fn`` raises."""
    try:
        fn()
    except InferenceServerException as e:
        return e.status(), e.message()
    raise AssertionError("no error")


# ---------------------------------------------------------------------------
# the same answers from both servers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stream", [False, True], ids=["unary", "stream"])
def test_simple_matches_reference_bridge(servers, stream):
    a, b = _ab(1)
    got = [_infer(u, "simple", _simple(a, b), ["OUTPUT0", "OUTPUT1"], stream)
           for u in _both(servers)]
    for name, want in (("OUTPUT0", a + b), ("OUTPUT1", a - b)):
        np.testing.assert_array_equal(got[0][name], want)
        np.testing.assert_array_equal(got[1][name], want)


@pytest.mark.parametrize("stream", [False, True], ids=["unary", "stream"])
def test_longctx_matches_reference_bridge(servers, stream):
    tokens = np.random.default_rng(9).integers(0, 256, (2, S)).astype(
        np.int32)
    arrays = [("TOKENS", "INT32", tokens)]
    port, ref = (_infer(u, "longctx_tpu", arrays, ["LOGPROBS"], stream)
                 for u in _both(servers))
    assert port["LOGPROBS"].shape == (2, S)
    assert np.isfinite(port["LOGPROBS"]).all()
    np.testing.assert_allclose(port["LOGPROBS"], ref["LOGPROBS"], rtol=0,
                               atol=5e-2)


@pytest.mark.parametrize("stream", [False, True], ids=["unary", "stream"])
def test_moe_matches_reference_bridge(servers, stream):
    tokens = np.random.default_rng(17).integers(
        0, jlang.moe_cfg().vocab_size, (4, jlang.moe_seq_len()),
        dtype=np.int32)
    arrays = [("TOKENS", "INT32", tokens)]
    port, ref = (_infer(u, "moe_tpu", arrays, ["NEXT_TOKEN", "NEXT_LOGIT"],
                        stream) for u in _both(servers))
    assert port["NEXT_TOKEN"].shape == port["NEXT_LOGIT"].shape == (4, 1)
    np.testing.assert_allclose(port["NEXT_LOGIT"], ref["NEXT_LOGIT"],
                               rtol=0, atol=5e-2)
    np.testing.assert_array_equal(port["NEXT_TOKEN"], ref["NEXT_TOKEN"])


@pytest.mark.parametrize("stream", [False, True], ids=["unary", "stream"])
def test_ensemble_matches_reference_bridge(servers, stream):
    texts = np.array(TEXTS, dtype=object).reshape(-1, 1)
    arrays = [("TEXT", "BYTES", texts)]
    port, ref = (_infer(u, "ensemble_llama", arrays,
                        ["OUT_TEXT", "NEXT_TOKEN"], stream)
                 for u in _both(servers))
    assert port["OUT_TEXT"].shape == (len(TEXTS), 1)
    for i, tok in enumerate(port["NEXT_TOKEN"].reshape(-1)):
        assert port["OUT_TEXT"][i, 0] == bytes([int(tok) % 256])
    np.testing.assert_array_equal(port["NEXT_TOKEN"], ref["NEXT_TOKEN"])
    assert port["OUT_TEXT"].tolist() == ref["OUT_TEXT"].tolist()


def test_metadata_and_config_as_json_match(servers):
    port, ref = (tgrpc.InferenceServerClient(u) for u in _both(servers))
    try:
        for name in ("simple", "longctx_tpu", "moe_tpu", "llama_tpu",
                     "ensemble_llama"):
            t, j = (c.get_model_metadata(name, as_json=True)
                    for c in (port, ref))
            for key in ("name", "versions", "inputs", "outputs"):
                assert t[key] == j[key], (name, key)
            t, j = (c.get_model_config(name, as_json=True)["config"]
                    for c in (port, ref))
            # instance_group names the device: KIND_TPU in the reference
            for key in ("name", "max_batch_size", "input", "output",
                        "dynamic_batching", "ensemble_scheduling"):
                assert t.get(key) == j.get(key), (name, key)
            assert port.is_model_ready(name, "1") and \
                ref.is_model_ready(name, "1")
        assert port.get_model_config("ensemble_llama", as_json=True) == \
            ref.get_model_config("ensemble_llama", as_json=True)
        t, j = (c.get_server_metadata(as_json=True) for c in (port, ref))
        assert sorted(t) == sorted(j) == ["extensions", "name", "version"]
        assert port.is_server_live() and port.is_server_ready()
        assert not port.is_model_ready("nope") and \
            not ref.is_model_ready("nope")
    finally:
        port.close()
        ref.close()


def test_response_as_json_matches_reference_grpc_client(servers):
    """The port's JSON forms are MessageToDict's: the reference's gRPC
    client (grpcio, HTTP/2, on the reference's gRPC port) and the port's
    client on the port's server, for the same request."""
    jh, th = servers
    a, b = _ab(4)
    with jgrpc.InferenceServerClient(jh.grpc_url) as jc:
        j = jc.infer("simple", _inputs(jgrpc, _simple(a, b)),
                     request_id="rq-7")
    with tgrpc.InferenceServerClient(th.http_url) as tc:
        t = tc.infer("simple", _inputs(tgrpc, _simple(a, b)),
                     request_id="rq-7")
    tj, jj = t.get_response(as_json=True), j.get_response(as_json=True)
    # the reference echoes a generated trace id in the parameters
    tj.pop("parameters", None)
    jj.pop("parameters", None)
    assert tj == jj
    assert t.get_output("OUTPUT1", as_json=True) == \
        j.get_output("OUTPUT1", as_json=True)


# ---------------------------------------------------------------------------
# statuses and error texts
# ---------------------------------------------------------------------------

def _error_cases(c):
    a, b = _ab(2)
    ok = _inputs(tgrpc, _simple(a, b))
    bad_dtype = _inputs(tgrpc, [("INPUT0", "FP32", a.astype(np.float32)),
                                ("INPUT1", "INT32", b)])
    bad_shape = _inputs(tgrpc, [("INPUT0", "INT32", np.zeros((1, 8),
                                                             np.int32)),
                                ("INPUT1", "INT32", b)])
    return {
        "unknown model": lambda: c.infer("nope", ok),
        "unknown version": lambda: c.infer("simple", ok, model_version="9"),
        "wrong datatype": lambda: c.infer("simple", bad_dtype),
        "wrong shape": lambda: c.infer("simple", bad_shape),
        "missing input": lambda: c.infer("simple", ok[:1]),
        "unknown output": lambda: c.infer(
            "simple", ok, outputs=[tgrpc.InferRequestedOutput("NOPE")]),
        "metadata of unknown model": lambda: c.get_model_metadata("nope"),
        "config of unknown model": lambda: c.get_model_config("nope"),
        "statistics of unknown model":
            lambda: c.get_inference_statistics("nope"),
        "register a missing key": lambda: c.register_system_shared_memory(
            "r0", f"/tct_grpc_missing_{uuid.uuid4().hex[:8]}", 64),
        "input in no region": lambda: c.infer("simple", [
            tgrpc.InferInput("INPUT0", [1, 16], "INT32").set_shared_memory(
                "nowhere", 64), ok[1]]),
    }


def test_error_statuses_and_texts_match_reference(servers):
    port, ref = (tgrpc.InferenceServerClient(u) for u in _both(servers))
    try:
        t_cases, j_cases = _error_cases(port), _error_cases(ref)
        for name in t_cases:
            t, j = _err(t_cases[name]), _err(j_cases[name])
            assert t == j, name
            assert t[0].startswith("StatusCode."), (name, t)
    finally:
        port.close()
        ref.close()


def test_raw_contents_count_is_checked(servers):
    """raw_input_contents must hold one entry per input not in a region."""
    a, b = _ab(3)
    request = get_inference_request("simple", _inputs(tgrpc, _simple(a, b)),
                                    "", "", None, 0, False, False, 0, None,
                                    None)
    request.raw_input_contents.append(b"extra")
    got = []
    for url in _both(servers):
        pool = thttp._client._ConnectionPool(url, 1, 60, 60)
        try:
            with pytest.raises(_transport.RpcError) as e:
                _transport.unary(pool, "ModelInfer",
                                 encode_frame(request),
                                 tp.ModelInferResponse, {})
        finally:
            pool.clear()
        got.append((e.value.code(), e.value.details()))
    assert got[0] == got[1]
    assert str(got[0][0]) == "StatusCode.INVALID_ARGUMENT"


def test_stream_errors_travel_in_band_as_in_reference(servers):
    a, b = _ab(5)
    results = []
    for url in _both(servers):
        with tgrpc.InferenceServerClient(url) as c:
            q = queue.Queue()
            c.start_stream(lambda result, error: q.put((result, error)))
            c.async_stream_infer("simple", _inputs(tgrpc, _simple(a, b)))
            c.async_stream_infer("nope", _inputs(tgrpc, _simple(a, b)))
            c.async_stream_infer("simple", _inputs(
                tgrpc, [("INPUT0", "FP32", a.astype(np.float32)),
                        ("INPUT1", "INT32", b)]))
            c.async_stream_infer("simple", _inputs(tgrpc, _simple(b, a)),
                                 request_id="last")
            got = [q.get(timeout=60) for _ in range(4)]
            c.stop_stream()
        results.append([
            (None, r.as_numpy("OUTPUT0").tolist(),
             r.get_response().id) if e is None
            else (e.status(), e.message(), None) for r, e in got])
    assert results[0] == results[1]
    assert results[0][1][0] == "StatusCode.INVALID_ARGUMENT"
    assert results[0][1][1].startswith("[400] ")
    assert results[0][3][2] == "last"


def _decoupled_stream(url, requests, empty_final=False):
    """Each of ``requests`` (model, arrays) sent on one stream; every
    response as (its outputs as lists, triton_final_response or None where
    it has none), in order, after stop_stream has waited for them all."""
    got = []
    with tgrpc.InferenceServerClient(url) as c:
        c.start_stream(lambda result, error: got.append((result, error)))
        for model, arrays in requests:
            c.async_stream_infer(model, _inputs(tgrpc, arrays),
                                 enable_empty_final_response=empty_final)
        c.stop_stream()
    out = []
    for result, error in got:
        assert error is None, error
        resp = result.get_response()
        final = resp.parameters.get("triton_final_response")
        out.append(({o.name: result.as_numpy(o.name).tolist()
                     for o in resp.outputs},
                    None if final is None else final.bool_param))
    return out


def _repeat(values, delays_us=None):
    values = np.asarray(values, np.int32)
    delays = np.asarray(delays_us if delays_us is not None
                        else [0] * len(values), np.uint32)
    return ("repeat_int32", [("IN", "INT32", values),
                             ("DELAY", "UINT32", delays),
                             ("WAIT", "UINT32", np.array([0], np.uint32))])


def _square(n):
    return ("square_int32", [("IN", "INT32", np.array([n], np.int32))])


@pytest.mark.parametrize("case", ["repeat", "square", "square 0", "mixed"])
def test_decoupled_stream_gives_n_responses_as_in_reference(servers, case):
    requests = {
        "repeat": [_repeat([4, -2, 9, 0, 2**31 - 1], [0, 2000, 0, 0, 1000])],
        "square": [_square(3)],
        "square 0": [_square(0)],
        "mixed": [_square(2), _repeat([7]), _square(0), _square(1)],
    }[case]
    t, j = (_decoupled_stream(u, requests) for u in _both(servers))
    assert t == j
    assert all(final is False for _, final in t)
    if case == "repeat":
        assert [r["OUT"] for r, _ in t] == [[4], [-2], [9], [0],
                                            [2**31 - 1]]
        assert [r["IDX"] for r, _ in t] == [[0], [1], [2], [3], [4]]
    want = {"repeat": 5, "square": 3, "square 0": 0, "mixed": 4}[case]
    assert len(t) == want
    if case == "square":
        assert [r["OUT"] for r, _ in t] == [[3]] * 3


@pytest.mark.parametrize("empty_final", [False, True])
def test_empty_final_response_only_when_asked(servers, empty_final):
    requests = [_repeat([1, 2]), _square(0), ("simple", _simple(*_ab(12)))]
    t, j = (_decoupled_stream(u, requests, empty_final)
            for u in _both(servers))
    assert t == j
    flags = [final for _, final in t]
    if empty_final:
        # repeat: 2 + the final; square 0: the final alone; simple: one
        # response, which a model that is not decoupled does not flag
        assert flags == [False, False, True, True, None]
        assert t[2][0] == {} and t[3][0] == {}
    else:
        assert flags == [False, False, None]


def test_unary_infer_on_a_decoupled_model_is_refused_as_in_reference(
        servers):
    model, arrays = _square(2)
    got = []
    for url in _both(servers):
        with thttp.InferenceServerClient(url) as hc, \
                tgrpc.InferenceServerClient(url) as gc:
            got.append((
                _err(lambda: hc.infer(model, _inputs(thttp, arrays))),
                _err(lambda: gc.infer(model, _inputs(tgrpc, arrays)))))
    assert got[0] == got[1]
    (hs, hm), (gs, gm) = got[0]
    assert hs == "400" and "decoupled transaction policy" in hm
    assert gs == "StatusCode.INVALID_ARGUMENT" and gm == hm


def test_unported_rpcs_answer_unimplemented_naming_the_roadmap(servers):
    """No RPC of the service is unported now: the repository RPCs answer
    as the reference's (an unknown model's load is INTERNAL with the same
    text); TLS (once refused naming its ROADMAP item) is a round trip on
    the committed test pair, with the same answer as the plain port, and
    ``infer_many`` (once refused) now answers."""
    jh, th = servers
    answers = []
    for url in (th.http_url, jh.http_url):
        pool = thttp._client._ConnectionPool(url, 1, 60, 60)
        try:
            index = _transport.unary(
                pool, "RepositoryIndex",
                encode_frame(tp.RepositoryIndexRequest(ready=True)),
                tp.RepositoryIndexResponse, {})
            with pytest.raises(_transport.RpcError) as e:
                _transport.unary(
                    pool, "RepositoryModelLoad",
                    encode_frame(tp.RepositoryModelLoadRequest(
                        model_name="nope")),
                    tp.RepositoryModelLoadResponse, {})
            # the port serves one model more, its own sequence model
            answers.append((sorted(m.name for m in index.models
                                   if m.name != "seqm"),
                            str(e.value.code()), e.value.details()))
        finally:
            pool.clear()
    assert answers[0] == answers[1]
    assert answers[0][1] == "StatusCode.INTERNAL"
    with tgrpc.InferenceServerClient(th.http_url) as c:
        assert c.infer_many("simple", []) == []
        plain = c.infer("simple", _inputs(tgrpc, _simple(*_ab(5))))
    from triton_client_tpu_torch.server.tls import TLSConfig

    registry = ModelRegistry()
    registry.register_model(tzoo.make_simple())
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "torch_tls")
    tls = TLSConfig(os.path.join(data, "server.crt"),
                    os.path.join(data, "server.key"))
    with ServerHarness(registry, host="localhost", tls=tls) as h, \
            tgrpc.InferenceServerClient(
                h.http_url, ssl=True,
                root_certificates=tls.certfile) as c:
        assert c.is_server_live()
        secure = c.infer("simple", _inputs(tgrpc, _simple(*_ab(5))))
    for name in ("OUTPUT0", "OUTPUT1"):
        np.testing.assert_array_equal(secure.as_numpy(name),
                                      plain.as_numpy(name))
    # keepalive options and channel args are taken, and mean nothing
    tgrpc.InferenceServerClient(
        th.http_url, keepalive_options=tgrpc.KeepAliveOptions(),
        channel_args=[("grpc.max_send_message_length", 1)]).close()


def test_content_type_is_checked_as_in_reference(servers):
    statuses = []
    for url in _both(servers):
        conn = http.client.HTTPConnection(url)
        try:
            conn.request("POST", "/inference.GRPCInferenceService/ServerLive",
                         body=b"\x00\x00\x00\x00\x00",
                         headers={"Content-Type": "text/plain"})
            statuses.append(conn.getresponse().status)
        finally:
            conn.close()
    assert statuses == [415, 415]


# ---------------------------------------------------------------------------
# the port's gRPC and HTTP answers, shared memory
# ---------------------------------------------------------------------------

def test_grpc_answers_equal_http_answers_on_port_server(servers):
    _, th = servers
    a, b = _ab(6)
    tokens = np.random.default_rng(10).integers(0, 256, (1, S)).astype(
        np.int32)
    texts = np.array(TEXTS[:2], dtype=object).reshape(-1, 1)
    cases = [("simple", _simple(a, b), ["OUTPUT0", "OUTPUT1"]),
             ("longctx_tpu", [("TOKENS", "INT32", tokens)], ["LOGPROBS"]),
             ("ensemble_llama", [("TEXT", "BYTES", texts)],
              ["OUT_TEXT", "NEXT_TOKEN"])]
    with thttp.InferenceServerClient(th.http_url) as hc:
        for model, arrays, outputs in cases:
            res = hc.infer(model, _inputs(thttp, arrays), outputs=[
                thttp.InferRequestedOutput(o, binary_data=True)
                for o in outputs])
            got = _infer(th.http_url, model, arrays, outputs)
            for o in outputs:
                assert got[o].tolist() == res.as_numpy(o).tolist(), (model,
                                                                     o)


def _shm_round_trip(url, kind, a, b):
    """simple by shared memory over gRPC: (OUTPUT0, its output entry as
    JSON, the status list as JSON, the list after unregister)."""
    with tgrpc.InferenceServerClient(url) as c:
        handles = []
        try:
            for name, arr in (("gin0", a), ("gin1", b), ("gout0", None)):
                if kind == "system":
                    key = f"/tctgrpc_{uuid.uuid4().hex[:10]}"
                    h = tsys.create_shared_memory_region(name, key, 64)
                    c.register_system_shared_memory(name, key, 64)
                    mod = tsys
                else:
                    h = tcuda.create_shared_memory_region(name, 64, 0,
                                                          device="cpu")
                    c.register_cuda_shared_memory(
                        name, tcuda.get_raw_handle(h), 0, 64)
                    mod = tcuda
                handles.append((mod, h))
                if arr is not None:
                    mod.set_shared_memory_region(h, [arr])
            ins = [tgrpc.InferInput(n, [1, 16], "INT32").set_shared_memory(
                r, 64) for n, r in (("INPUT0", "gin0"), ("INPUT1", "gin1"))]
            out = tgrpc.InferRequestedOutput("OUTPUT0").set_shared_memory(
                "gout0", 64)
            res = c.infer("simple", ins, outputs=[out])
            assert res.as_numpy("OUTPUT0") is None
            mod, h = handles[2]
            got = np.array(mod.get_contents_as_numpy(h, np.int32, [1, 16]))
            status = (c.get_system_shared_memory_status if kind == "system"
                      else c.get_cuda_shared_memory_status)
            before = status(as_json=True)
            one = status("gin1", as_json=True)
            (c.unregister_system_shared_memory if kind == "system"
             else c.unregister_cuda_shared_memory)()
            return got, res.get_output("OUTPUT0", as_json=True), before, \
                one, status(as_json=True)
        finally:
            for mod, h in handles:
                mod.destroy_shared_memory_region(h)


def test_system_shm_over_grpc_matches_reference(servers):
    a, b = _ab(7)
    port, ref = (_shm_round_trip(u, "system", a, b) for u in _both(servers))
    np.testing.assert_array_equal(port[0], a + b)
    np.testing.assert_array_equal(ref[0], a + b)
    assert port[1] == ref[1]
    for res in (port, ref):
        for status in res[2:4]:
            for r in status.get("regions", {}).values():
                r["key"] = "k"
    assert port[2:] == ref[2:]
    assert sorted(port[2]["regions"]) == ["gin0", "gin1", "gout0"]
    assert port[4] == {}
    assert not [k for k in os.listdir("/dev/shm") if k.startswith("tctgrpc_")]


def test_cuda_shm_over_grpc_on_port_server(servers):
    _, th = servers
    a, b = _ab(8)
    got, entry, before, one, after = _shm_round_trip(th.http_url, "cuda",
                                                     a, b)
    np.testing.assert_array_equal(got, a + b)
    assert entry["parameters"]["shared_memory_region"] == {
        "string_param": "gout0"}
    assert sorted(before["regions"]) == ["gin0", "gin1", "gout0"]
    assert list(one["regions"]) == ["gin1"]
    assert after == {}
    assert tcuda.allocated_shared_memory_regions() == []
    assert th.core.cuda_shm.status(None) == {}


# ---------------------------------------------------------------------------
# the stream, sequences, statistics
# ---------------------------------------------------------------------------

def test_stream_keeps_order_and_stop_waits_for_every_answer(servers):
    _, th = servers
    a, b = _ab(11)
    with tgrpc.InferenceServerClient(th.http_url) as c:
        seen = []
        c.start_stream(lambda result, error: seen.append(
            (result.get_response().id if result else None, error)))
        prep = c.prepare("simple", _inputs(tgrpc, _simple(a, b)))
        for i in range(20):
            prep.async_stream_infer(request_id=str(i))
        c.stop_stream()
        assert seen == [(str(i), None) for i in range(20)]
        with pytest.raises(InferenceServerException,
                           match="start_stream"):
            c.async_stream_infer("simple", _inputs(tgrpc, _simple(a, b)))
        # a second stream on the same client, cancelled: one CANCELLED
        errors = queue.Queue()
        c.start_stream(lambda result, error: errors.put(error))
        c.async_stream_infer("simple", _inputs(tgrpc, _simple(a, b)))
        assert errors.get(timeout=60) is None
        c.stop_stream(cancel_requests=True)
        err = errors.get(timeout=60)
        assert err.status() == "StatusCode.CANCELLED"
        assert errors.empty()


def test_sequence_requests_bypass_the_batcher(servers):
    """Four concurrent streams of one sequence each run as four executions
    with no batch; the same requests without a sequence id coalesce.  In
    an ensemble, a sequence request's member step still goes through the
    member's batcher (the sequence keys stripped)."""
    _, th = servers
    model = th.registry.get("seqm")
    st = model.stats
    x = np.arange(4, dtype=np.int32).reshape(1, 4)

    def run(seq):
        with tgrpc.InferenceServerClient(th.http_url) as c:
            ins = _inputs(tgrpc, [("X", "INT32", x)])
            if seq is None:
                c.infer("seqm", ins)
                return
            q = queue.Queue()
            c.start_stream(lambda result, error: q.put(error))
            c.async_stream_infer("seqm", ins, sequence_id=seq,
                                 sequence_start=True, sequence_end=True)
            assert q.get(timeout=60) is None
            c.stop_stream()

    for seqs, batched in (([1, "s-2", 3, 4], False), ([None] * 4, True)):
        execs0, batches0 = st.execution_count, st.batch_execution_count
        threads = [threading.Thread(target=run, args=(s,)) for s in seqs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        if batched:
            assert st.batch_execution_count - batches0 >= 1
            assert st.execution_count - execs0 < 4
        else:
            assert st.batch_execution_count == batches0
            assert st.execution_count - execs0 == 4
    llama = th.registry.get("llama_tpu").stats
    before = llama.batch_execution_count
    with tgrpc.InferenceServerClient(th.http_url) as c:
        q = queue.Queue()
        c.start_stream(lambda result, error: q.put(error))
        c.async_stream_infer("ensemble_llama", _inputs(tgrpc, [(
            "TEXT", "BYTES", np.array([[b"seq"]], dtype=object))]),
            sequence_id=9, sequence_start=True)
        assert q.get(timeout=120) is None
        c.stop_stream()
    assert llama.batch_execution_count == before + 1


def _masked(stats):
    """Statistics with the times masked: the counts must agree."""
    out = json.loads(json.dumps(stats))
    for m in out["model_stats"]:
        m["last_inference"] = "t" if int(m.get("last_inference", 0)) else 0
        for d in m["inference_stats"].values():
            if "ns" in d:
                d["ns"] = "t" if int(d["ns"]) else 0
    return out


def test_statistics_match_reference_counts():
    jreg, treg = JaxRegistry(), ModelRegistry()
    jreg.register_model(jzoo.make_simple())
    treg.register_model(tzoo.make_simple())
    a, b = _ab(12)
    with JaxHarness(jreg) as jh, ServerHarness(treg) as th:
        results = []
        for url in (th.http_url, jh.http_url):
            with thttp.InferenceServerClient(url) as hc, \
                    tgrpc.InferenceServerClient(url) as gc:
                before = gc.get_inference_statistics("simple", as_json=True)
                for _ in range(3):
                    hc.infer("simple", _inputs(thttp, _simple(a, b)))
                gc.infer("simple", _inputs(tgrpc, _simple(a, b)))
                _err(lambda: gc.infer("simple", _inputs(tgrpc, [
                    ("INPUT0", "INT32", a)])))
                results.append((
                    before, hc.get_inference_statistics(),
                    hc.get_inference_statistics("simple"),
                    hc.get_inference_statistics("simple", "1"),
                    gc.get_inference_statistics("simple", as_json=True),
                    gc.get_inference_statistics(as_json=True)))
        port, ref = results
        for t, j in zip(port[1:4], ref[1:4]):
            assert _masked(t) == _masked(j)
        assert port[1]["model_stats"][0]["inference_count"] == 4
        assert port[1]["model_stats"][0]["execution_count"] == 4
        for t, j in ((port[0], ref[0]), (port[4], ref[4]),
                     (port[5], ref[5])):
            assert _masked(t) == _masked(j)
        # gRPC reads the counters the HTTP route reads
        http_row = port[2]["model_stats"][0]
        grpc_row = port[4]["model_stats"][0]
        assert int(grpc_row["inference_count"]) == \
            http_row["inference_count"]
        assert _err(lambda: thttp.InferenceServerClient(
            th.http_url).get_inference_statistics("nope"))[0] == "400"


# ---------------------------------------------------------------------------
# the client: async, the template, chunked bodies, perf_analyzer
# ---------------------------------------------------------------------------

def test_async_infer_future_and_callback(servers):
    _, th = servers
    with tgrpc.InferenceServerClient(th.http_url) as c:
        pairs = [_ab(20 + i) for i in range(8)]
        handles = [c.async_infer("simple", _inputs(tgrpc, _simple(a, b)))
                   for a, b in pairs]
        for (a, b), h in zip(pairs, handles):
            np.testing.assert_array_equal(
                h.get_result(timeout=60).as_numpy("OUTPUT0"), a + b)
        done = queue.Queue()
        ctx = c.async_infer("nope", _inputs(tgrpc, _simple(*pairs[0])),
                            callback=lambda result, error: done.put(
                                (result, error)))
        result, error = done.get(timeout=60)
        assert result is None and \
            error.status() == "StatusCode.INVALID_ARGUMENT"
        assert ctx.cancel() is False  # already done


def test_prepared_request_is_the_slow_path_byte_for_byte():
    a, b = _ab(30)
    ins = _inputs(tgrpc, _simple(a, b))
    outs = [tgrpc.InferRequestedOutput("OUTPUT0")]
    prep = tgrpc.InferenceServerClient("127.0.0.1:1").prepare(
        "simple", ins, outputs=outs, parameters={"p": 1})
    for rid, timeout in (("", None), ("req-9", None), ("", 2500)):
        slow = get_inference_request("simple", ins, "", rid, outs, 0, False,
                                     False, 0, timeout, {"p": 1})
        stamped = prep.template.stamp(rid, timeout_us=timeout)
        assert tp.ModelInferRequest.FromString(stamped[5:]) == slow
        if timeout is None:
            assert stamped == encode_frame(slow)
    ins[0].set_shape([2, 8])
    with pytest.raises(InferenceServerException, match="re-prepare"):
        prep.template.stamp()


def test_chunked_request_body_on_an_http_route(servers):
    _, th = servers
    a, b = _ab(31)
    body = json.dumps({"inputs": [
        {"name": n, "datatype": "INT32", "shape": [1, 16],
         "data": x.reshape(-1).tolist()}
        for n, x in (("INPUT0", a), ("INPUT1", b))]}).encode()
    conn = http.client.HTTPConnection(th.http_url)
    try:
        conn.putrequest("POST", "/v2/models/simple/infer")
        conn.putheader("Transfer-Encoding", "chunked")
        conn.endheaders()
        for i in range(0, len(body), 50):
            piece = body[i:i + 50]
            conn.send(b"%X\r\n%s\r\n" % (len(piece), piece))
            time.sleep(0.001)
        conn.send(b"0\r\n\r\n")
        resp = conn.getresponse()
        out = json.loads(resp.read())
    finally:
        conn.close()
    assert resp.status == 200
    got = {o["name"]: o["data"] for o in out["outputs"]}
    assert got["OUTPUT0"] == (a + b).reshape(-1).tolist()


def _results(out):
    return [json.loads(ln.split("result ", 1)[1]) for ln in out.splitlines()
            if ln.startswith("  result ")]


@pytest.mark.parametrize("extra", [
    ["-i", "grpc"], ["-i", "grpc", "--streaming"],
    ["-i", "grpc", "--streaming", "--shared-memory", "system"],
    ["-i", "grpc", "--shared-memory", "cuda",
     "--cuda-shared-memory-device", "cpu"],
    ["-i", "grpc", "--streaming", "--request-rate-range", "40",
     "--max-threads", "2"],
], ids=["unary", "stream", "stream system shm", "unary cuda shm",
        "stream open loop"])
def test_perf_analyzer_over_grpc_on_simple(servers, extra, capsys, tmp_path):
    _, th = servers
    args = ["-m", "simple", "-u", th.http_url, "--measurement-interval",
            "300", "-v", "-f", str(tmp_path / "r.csv"), *extra]
    if "--request-rate-range" not in extra:
        args += ["--concurrency-range", "1:2"]
    rc = tpa.main(args)
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "Protocol: grpc" in out
    results = _results(out)
    assert results and all(r["errors"] == 0 for r in results), out
    assert all(r["throughput"] > 0 for r in results), out
    assert th.core.system_shm.status(None) == {}
    assert th.core.cuda_shm.status(None) == {}
    assert tcuda.allocated_shared_memory_regions() == []
    assert not [k for k in os.listdir("/dev/shm")
                if k.startswith(f"pa_{os.getpid()}_")]
    assert (tmp_path / "r.csv").read_text().count("\n") == len(results) + 1
