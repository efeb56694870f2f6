"""The port's gRPC over HTTP/2 (``--grpc-port``: ``server/grpc_h2.py``,
``grpc/_h2_transport.py``, ``grpc/aio/_h2.py``) against stock HTTP/2
gRPC, on the CPU.

Both packages' in-process servers serve ``simple``, the decoupled
``repeat_int32`` and ``square_int32``, the tiny ``longctx_tpu`` (the
reference's seed-11 weights carried to the port as numpy arrays) and
``ensemble_llama`` over the tiny ``llama_tpu`` (seed 3); the reference
serves gRPC with ``grpc.aio``, the port with its own HTTP/2.

1. The reference's client (grpcio's C-core HTTP/2, its Huffman-coded
   headers, dynamic table and flow control) gets from the port's gRPC
   port what it gets from the reference's: ``simple`` exactly,
   ``longctx_tpu`` within 5e-2 (test_torch_grpc.py's bound),
   ``ensemble_llama`` exactly, decoupled streams response for response,
   statuses, error texts, trailing metadata, metadata and config.
2. The port's client pinned to ``h2`` gets the same from the reference's
   ``grpc.aio`` server as from the port's, and each of its answers over
   HTTP/2 equals the same request's answer over gRPC-Web on the port's
   HTTP port, byte for byte.
3. The reference's Python gRPC examples (``tests/test_examples.py``'s
   ``GRPC_EXAMPLES``) run unchanged against the port's gRPC port, but
   ``simple_grpc_cudashm_client.py`` (CUDA shared memory: the reference's
   stand-in and the port's CUDA regions differ, ROADMAP C) and
   ``simple_grpc_model_control.py`` (the zoo is not a repository: ROADMAP
   C).
4. The native client's gRPC examples (nghttp2's HPACK) with
   ``TC_TPU_GRPC_TRANSPORT=h2``, where they are built.
5. TLS with ALPN ``h2``: grpcio's ``ssl_channel_credentials`` against the
   port, the port's client against the reference, the aio client too.
6. The ingress cap: RESOURCE_EXHAUSTED from the message's prefix, and the
   connection serves on.
7. ``grpc-timeout``: DEADLINE_EXCEEDED from the server itself.
8. gzip and deflate requests; an unknown ``grpc-encoding`` is
   UNIMPLEMENTED.
9. 32 ``async_infer`` calls multiplexed on one connection.
10. A cancelled stream (RST_STREAM) cancels the server's call.
11. GOAWAY on drain: the calls in flight finish, no caller error.
12. The transport probe and its ``TC_TPU_GRPC_TRANSPORT`` pin; the CLI's
    ``--grpc-port 0`` read back from its start line.
"""

import asyncio
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import grpc
import jax

from triton_client_tpu import grpc as jgrpc
from triton_client_tpu.models import language as jlang
from triton_client_tpu.models import transformer as jtr
from triton_client_tpu.models import zoo as jzoo
from triton_client_tpu.server.registry import ModelRegistry as JaxRegistry
from triton_client_tpu.server.testing import ServerHarness as JaxHarness
from triton_client_tpu.server.tls import TLSConfig as JaxTLS
from triton_client_tpu.utils import InferenceServerException as JaxError
from triton_client_tpu_torch import grpc as tgrpc
from triton_client_tpu_torch.grpc import aio as tgrpc_aio
from triton_client_tpu_torch.grpc._h2_transport import H2Transport
from triton_client_tpu_torch.grpc._transport import WebTransport
from triton_client_tpu_torch.models import language as tlang
from triton_client_tpu_torch.models import zoo as tzoo
from triton_client_tpu_torch.protocol import h2
from triton_client_tpu_torch.protocol.grpc_web import encode_frame
from triton_client_tpu_torch.protocol import inference as tp
from triton_client_tpu_torch.server.memory import oversize_message
from triton_client_tpu_torch.server.model import PyModel, make_config
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import (ServerHarness,
                                                    cli_grpc_port,
                                                    cli_http_port)
from triton_client_tpu_torch.server.tls import TLSConfig
from triton_client_tpu_torch.utils import InferenceServerException

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TLS_PAIR = (os.path.join(REPO, "tests", "data", "torch_tls", "server.crt"),
            os.path.join(REPO, "tests", "data", "torch_tls", "server.key"))
S = 512  # the tiny longctx_tpu preset's window
TEXTS = [b"the quick brown fox", "h\xe9llo".encode(), b"", b"x" * 300]
ERRORS = (InferenceServerException, JaxError)


def _sleepy():
    """``sleepy``: Y = X, after sleeping X[0] milliseconds."""
    cfg = make_config("sleepy", [("X", "INT32", [1])], [("Y", "INT32", [1])])

    def fn(inputs, params):
        x = np.asarray(inputs["X"])
        time.sleep(int(x[0]) / 1e3)
        return {"Y": x.astype(np.int32)}

    return PyModel(cfg, fn)


def _port_registry():
    longctx = {k: np.asarray(v) for k, v in jtr.init_params(
        jax.random.PRNGKey(11), jlang.longctx_cfg()).items()}
    llama = {k: np.asarray(v) for k, v in jtr.init_params(
        jax.random.PRNGKey(3), jlang._llama_cfg()).items()}
    treg = ModelRegistry()
    for m in (tzoo.make_simple(), tzoo.make_repeat_int32(),
              tzoo.make_square_int32(),
              tlang.make_longctx_tpu("cpu", params=longctx),
              tlang.make_llama_preprocess(),
              tlang.make_llama_tpu("cpu", params=llama),
              tlang.make_llama_postprocess(), tlang.make_ensemble_llama(),
              _sleepy()):
        treg.register_model(m)
    return treg


@pytest.fixture(scope="module")
def servers():
    """(the port's harness, the reference's harness)."""
    jreg = JaxRegistry()
    for m in (jzoo.make_simple(), jzoo.make_repeat_int32(),
              jzoo.make_square_int32(), jlang.make_longctx_tpu(),
              jlang.make_llama_preprocess(), jlang.make_llama_tpu(),
              jlang.make_llama_postprocess(), jlang.make_ensemble_llama()):
        jreg.register_model(m)
    with JaxHarness(jreg) as jh, ServerHarness(_port_registry()) as th:
        yield th, jh


@pytest.fixture
def pin(monkeypatch):
    """Pin the port's client to a wire."""
    def set_pin(wire):
        monkeypatch.setenv("TC_TPU_GRPC_TRANSPORT", wire)
    return set_pin


def _ab(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-1000, 1000, (1, 16)).astype(np.int32),
            rng.integers(-1000, 1000, (1, 16)).astype(np.int32))


def _inputs(mod, arrays):
    out = []
    for name, dt, arr in arrays:
        x = mod.InferInput(name, list(arr.shape), dt)
        x.set_data_from_numpy(arr)
        out.append(x)
    return out


def _repeat(values, delays_us=None, wait_us=0):
    values = np.asarray(values, np.int32)
    delays = np.asarray(delays_us if delays_us is not None
                        else [0] * len(values), np.uint32)
    return ("repeat_int32", [("IN", "INT32", values),
                             ("DELAY", "UINT32", delays),
                             ("WAIT", "UINT32", np.array([wait_us],
                                                         np.uint32))])


# the requests both servers answer: (model, arrays, outputs, bound)
_LONGCTX = np.random.default_rng(9).integers(0, 256, (2, S)).astype(np.int32)
REQUESTS = {
    "simple": ("simple", [("INPUT0", "INT32", _ab(1)[0]),
                          ("INPUT1", "INT32", _ab(1)[1])],
               ["OUTPUT0", "OUTPUT1"], 0),
    "longctx_tpu": ("longctx_tpu", [("TOKENS", "INT32", _LONGCTX)],
                    ["LOGPROBS"], 5e-2),
    "ensemble_llama": ("ensemble_llama",
                       [("TEXT", "BYTES",
                         np.array(TEXTS, dtype=object).reshape(-1, 1))],
                       ["OUT_TEXT", "NEXT_TOKEN"], 0),
}


def _answer(mod, url, case, stream=False):
    model, arrays, outputs, _ = REQUESTS[case]
    with mod.InferenceServerClient(url) as c:
        outs = [mod.InferRequestedOutput(o) for o in outputs]
        if not stream:
            res = c.infer(model, _inputs(mod, arrays), outputs=outs)
        else:
            q = queue.Queue()
            c.start_stream(lambda result, error: q.put((result, error)))
            c.async_stream_infer(model, _inputs(mod, arrays), outputs=outs)
            res, err = q.get(timeout=120)
            c.stop_stream()
            assert err is None, err
        return {o: res.as_numpy(o) for o in outputs}


def _client(which, pin):
    if which == "port_h2":
        pin("h2")
        return tgrpc
    return jgrpc


# ---------------------------------------------------------------------------
# 1-2. the same answers from both servers, for grpcio and the port's client
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stream", [False, True], ids=["unary", "stream"])
@pytest.mark.parametrize("case", sorted(REQUESTS))
@pytest.mark.parametrize("which", ["grpcio", "port_h2"])
def test_answers_match_the_reference_server(servers, pin, which, case,
                                            stream):
    th, jh = servers
    mod = _client(which, pin)
    port = _answer(mod, th.grpc_url, case, stream)
    ref = _answer(mod, jh.grpc_url, case, stream)
    bound = REQUESTS[case][3]
    for name in port:
        assert port[name].shape == ref[name].shape
        if port[name].dtype == object or not bound:
            assert port[name].tolist() == ref[name].tolist(), name
        else:
            assert np.isfinite(port[name]).all()
            np.testing.assert_allclose(port[name], ref[name], rtol=0,
                                       atol=bound)


@pytest.mark.parametrize("case", sorted(REQUESTS))
def test_h2_answers_equal_grpc_web_answers_byte_for_byte(servers, pin,
                                                         case):
    th, _ = servers
    model, arrays, outputs, _ = REQUESTS[case]

    def raw(url):
        with tgrpc.InferenceServerClient(url) as c:
            resp = c.infer(model, _inputs(tgrpc, arrays), outputs=[
                tgrpc.InferRequestedOutput(o) for o in outputs],
                request_id="same").get_response()
        return ([bytes(x) for x in resp.raw_output_contents],
                [(o.name, o.datatype, list(o.shape)) for o in resp.outputs])

    pin("h2")
    over_h2 = raw(th.grpc_url)
    pin("web")
    assert raw(th.http_url) == over_h2


def _error_cases(mod, c):
    a, b = _ab(2)
    ok = _inputs(mod, [("INPUT0", "INT32", a), ("INPUT1", "INT32", b)])
    return {
        "unknown model": lambda: c.infer("nope", ok),
        "wrong datatype": lambda: c.infer("simple", _inputs(
            mod, [("INPUT0", "FP32", a.astype(np.float32)),
                  ("INPUT1", "INT32", b)])),
        "missing input": lambda: c.infer("simple", ok[:1]),
        "metadata of no model": lambda: c.get_model_metadata("nope"),
        "config of no model": lambda: c.get_model_config("nope"),
        "statistics of no model": lambda: c.get_inference_statistics("nope"),
        "unary on a decoupled model": lambda: c.infer(
            "repeat_int32", _inputs(mod, _repeat([1])[1])),
    }


def _err(fn):
    try:
        fn()
    except ERRORS as e:
        return e.status(), e.message()
    raise AssertionError("no error")


@pytest.mark.parametrize("which", ["grpcio", "port_h2"])
def test_statuses_and_texts_match(servers, pin, which):
    th, jh = servers
    mod = _client(which, pin)
    with mod.InferenceServerClient(th.grpc_url) as tc, \
            mod.InferenceServerClient(jh.grpc_url) as jc:
        t_cases, j_cases = _error_cases(mod, tc), _error_cases(mod, jc)
        for name in t_cases:
            t, j = _err(t_cases[name]), _err(j_cases[name])
            assert t == j, name
            assert t[0].startswith("StatusCode."), (name, t)


@pytest.mark.parametrize("which", ["grpcio", "port_h2"])
def test_metadata_and_config_match(servers, pin, which):
    th, jh = servers
    mod = _client(which, pin)
    with mod.InferenceServerClient(th.grpc_url) as tc, \
            mod.InferenceServerClient(jh.grpc_url) as jc:
        assert tc.is_server_live() and tc.is_server_ready()
        assert tc.is_model_ready("simple") == jc.is_model_ready("simple")
        for name in ("simple", "longctx_tpu", "ensemble_llama"):
            t = tc.get_model_metadata(name, as_json=True)
            j = jc.get_model_metadata(name, as_json=True)
            t.pop("platform"), j.pop("platform")
            assert t == j, name
        t = tc.get_model_config("ensemble_llama", as_json=True)
        j = jc.get_model_config("ensemble_llama", as_json=True)
        assert t == j


def _decoupled(mod, url, requests):
    got = []
    with mod.InferenceServerClient(url) as c:
        c.start_stream(lambda result, error: got.append((result, error)))
        for model, arrays in requests:
            c.async_stream_infer(model, _inputs(mod, arrays),
                                 enable_empty_final_response=True)
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


@pytest.mark.parametrize("which", ["grpcio", "port_h2"])
def test_decoupled_streams_match(servers, pin, which):
    th, jh = servers
    mod = _client(which, pin)
    requests = [_repeat([4, -2, 9], [0, 2000, 0]),
                ("square_int32", [("IN", "INT32", np.array([3], np.int32))]),
                _repeat([7])]
    t, j = _decoupled(mod, th.grpc_url, requests), \
        _decoupled(mod, jh.grpc_url, requests)
    assert t == j
    assert [r["OUT"] for r, _ in t if r] == [[4], [-2], [9], [3], [3], [3],
                                             [7]]


def test_pushback_travels_as_trailing_metadata(servers):
    """A refusal with pushback carries ``retry-after-ms`` in its trailers
    (grpcio reads it as trailing metadata)."""
    th, _ = servers
    core = th.core
    from triton_client_tpu_torch.server.types import InferError
    real = core.infer

    def refuse(req):
        raise InferError("shed", 429, retry_after_s=0.25)

    core.infer = refuse
    try:
        channel = grpc.insecure_channel(th.grpc_url)
        call = channel.unary_unary(
            "/inference.GRPCInferenceService/ModelInfer",
            request_serializer=lambda m: m,
            response_deserializer=lambda b: b)
        with pytest.raises(grpc.RpcError) as e:
            call(encode_frame(tp.ModelInferRequest(model_name="simple"))[5:],
                 metadata=(("triton-request-id", "r1"),))
        assert e.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
        assert e.value.details() == "shed"
        assert ("retry-after-ms", "250") in e.value.trailing_metadata()
        channel.close()
    finally:
        core.infer = real


# ---------------------------------------------------------------------------
# 3-4. the reference's examples, Python and native
# ---------------------------------------------------------------------------

GRPC_EXAMPLES = [
    "simple_grpc_infer_client.py",
    "simple_grpc_string_infer_client.py",
    "simple_grpc_health_metadata.py",
    "simple_grpc_shm_client.py",
    "simple_grpc_shm_string_client.py",
    "simple_grpc_sequence_sync_infer_client.py",
    "simple_grpc_sequence_stream_infer_client.py",
    "simple_grpc_async_infer_client.py",
    "simple_grpc_aio_infer_client.py",
    "simple_grpc_aio_sequence_stream_infer_client.py",
    "simple_grpc_custom_repeat.py",
    "simple_grpc_keepalive_client.py",
    "simple_grpc_custom_args_client.py",
    "grpc_client.py",
    "grpc_explicit_int_content_client.py",
    "grpc_explicit_int8_content_client.py",
    "grpc_explicit_byte_content_client.py",
    "grpc_image_client.py",
    "simple_grpc_decode_client.py",
]
#: GRPC_EXAMPLES of tests/test_examples.py that this file leaves out: the
#: design differences of ROADMAP C
LEFT_OUT = {"simple_grpc_cudashm_client.py", "simple_grpc_model_control.py"}


@pytest.fixture(scope="module")
def zoo():
    treg = ModelRegistry()
    tzoo.register_all(treg, device="cpu")
    with ServerHarness(treg) as h:
        yield h


def test_the_example_list_is_the_reference_one_less_two():
    sys.path.insert(0, os.path.join(REPO, "tests"))
    try:
        import test_examples
    finally:
        sys.path.pop(0)
    assert set(test_examples.GRPC_EXAMPLES) - LEFT_OUT == set(GRPC_EXAMPLES)


def _run(cmd, extra_env=None):
    env = dict(os.environ, PYTHONPATH=REPO, **(extra_env or {}))
    return subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          env=env, cwd=REPO)


@pytest.mark.parametrize("script", GRPC_EXAMPLES)
def test_reference_example_against_the_port(zoo, script):
    proc = _run([sys.executable, os.path.join(REPO, "examples", script),
                 "-u", zoo.grpc_url])
    if proc.returncode == 2 and "SKIP" in proc.stderr:
        pytest.skip(proc.stderr.strip().splitlines()[-1])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PASS" in proc.stdout, proc.stdout


NATIVE = os.path.join(REPO, "native", "client", "build")


@pytest.mark.parametrize("name", [
    "simple_grpc_infer_client", "simple_grpc_async_infer_client",
    "simple_grpc_health_metadata", "simple_grpc_keepalive_client",
    "simple_grpc_sequence_stream_infer_client", "simple_grpc_custom_repeat",
    "simple_grpc_shm_client"])
def test_native_example_over_h2(zoo, name):
    path = os.path.join(NATIVE, name)
    if not os.access(path, os.X_OK):
        pytest.skip(f"the native client is not built ({path})")
    # pinned to h2, the native client fails rather than fall back
    proc = _run([path, "-u", zoo.grpc_url], {"TC_TPU_GRPC_TRANSPORT": "h2"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PASS" in proc.stdout, proc.stdout


# ---------------------------------------------------------------------------
# 5. TLS, ALPN h2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tls_servers():
    treg = ModelRegistry()
    treg.register_model(tzoo.make_simple())
    jreg = JaxRegistry()
    jreg.register_model(jzoo.make_simple())
    with ServerHarness(treg, host="localhost",
                       tls=TLSConfig(*TLS_PAIR)) as th, \
            JaxHarness(jreg, host="localhost", tls=JaxTLS(*TLS_PAIR)) as jh:
        yield th, jh


def _simple_sum(mod, c):
    a, b = _ab(5)
    r = c.infer("simple", _inputs(mod, [("INPUT0", "INT32", a),
                                        ("INPUT1", "INT32", b)]))
    return r.as_numpy("OUTPUT0").tolist()


def test_grpcio_tls_credentials_against_the_port(tls_servers):
    th, jh = tls_servers
    got = []
    for url in (th.grpc_url, jh.grpc_url):
        with jgrpc.InferenceServerClient(url, ssl=True,
                                         root_certificates=TLS_PAIR[0]) as c:
            got.append(_simple_sum(jgrpc, c))
    assert got[0] == got[1]
    with open(TLS_PAIR[0], "rb") as f:
        creds = grpc.ssl_channel_credentials(root_certificates=f.read())
    with jgrpc.InferenceServerClient(th.grpc_url, creds=creds) as c:
        assert c.is_server_ready()


@pytest.mark.parametrize("where", ["port", "ref", "port_web"])
def test_port_client_over_tls(tls_servers, pin, where):
    th, jh = tls_servers
    pin("web" if where == "port_web" else "h2")
    url = {"port": th.grpc_url, "ref": jh.grpc_url,
           "port_web": th.http_url}[where]
    with tgrpc.InferenceServerClient(url, ssl=True,
                                     root_certificates=TLS_PAIR[0]) as c:
        got = _simple_sum(tgrpc, c)
        kind = WebTransport if where == "port_web" else H2Transport
        assert isinstance(c._wire, kind)
    a, b = _ab(5)
    assert got == (a + b).tolist()


def test_alpn_is_h2_on_the_grpc_port_only(tls_servers):
    import ssl
    th, _ = tls_servers
    got = {}
    for name, port in (("grpc", th.grpc_port), ("http", th.http_port)):
        ctx = ssl.create_default_context(cafile=TLS_PAIR[0])
        ctx.set_alpn_protocols(["h2", "http/1.1"])
        with socket.create_connection(("localhost", port)) as raw, \
                ctx.wrap_socket(raw, server_hostname="localhost") as s:
            got[name] = s.selected_alpn_protocol()
    assert got == {"grpc": "h2", "http": "http/1.1"}


def test_aio_client_over_tls(tls_servers):
    th, jh = tls_servers
    import ssl

    async def main(url):
        ctx = ssl.create_default_context(cafile=TLS_PAIR[0])
        async with tgrpc_aio.InferenceServerClient(url, creds=ctx) as c:
            a, b = _ab(5)
            r = await c.infer("simple", _inputs(
                tgrpc, [("INPUT0", "INT32", a), ("INPUT1", "INT32", b)]))
            return type(c._h2).__name__, r.as_numpy("OUTPUT0").tolist()

    port, ref = asyncio.run(main(th.grpc_url)), asyncio.run(
        main(jh.grpc_url))
    assert port == ref and port[0] == "AioH2Transport"


# ---------------------------------------------------------------------------
# 6-11. the cap, deadlines, encodings, multiplexing, cancel, drain
# ---------------------------------------------------------------------------

CAP = 8000


@pytest.fixture(scope="module")
def capped():
    treg = ModelRegistry()
    treg.register_model(tzoo.make_custom_identity_int32())
    with ServerHarness(treg, max_request_bytes=CAP) as h:
        yield h


def _identity(mod, n):
    x = np.arange(n, dtype=np.int32).reshape(1, n)
    i = mod.InferInput("INPUT0", [1, n], "INT32")
    i.set_data_from_numpy(x)
    return [i], x


@pytest.mark.parametrize("which", ["grpcio", "port_h2"])
def test_the_cap_refuses_from_the_prefix(capped, pin, which):
    mod = _client(which, pin)
    with mod.InferenceServerClient(capped.grpc_url) as c:
        small, x = _identity(mod, 16)
        np.testing.assert_array_equal(
            c.infer("custom_identity_int32", small).as_numpy("OUTPUT0"), x)
        for n in (4000, 1 << 20):  # one window, then many
            big, _ = _identity(mod, n)
            status, message = _err(
                lambda: c.infer("custom_identity_int32", big))
            assert status == "StatusCode.RESOURCE_EXHAUSTED"
            assert "exceeds the server's max request size of 8000" in \
                message
        # the connection and its window are sound after the refusals
        for _ in range(3):
            np.testing.assert_array_equal(c.infer(
                "custom_identity_int32", small).as_numpy("OUTPUT0"), x)
    _wait_idle(capped)


def _wait_idle(harness, timeout=10.0):
    """No call left in the gRPC port's exchange (a call leaves it just
    after its trailers went out)."""
    end = time.monotonic() + timeout
    while harness._grpc.active and time.monotonic() < end:
        time.sleep(0.02)
    assert harness._grpc.active == 0


def test_oversize_text_names_the_prefix_size(capped):
    big, _ = _identity(tgrpc, 4000)
    channel = grpc.insecure_channel(capped.grpc_url)
    call = channel.unary_unary("/inference.GRPCInferenceService/ModelInfer",
                               request_serializer=lambda m: m,
                               response_deserializer=lambda b: b)
    from triton_client_tpu_torch.grpc._utils import get_inference_request
    msg = encode_frame(get_inference_request(
        "custom_identity_int32", big, "", "", None, 0, False, False, 0,
        None, None))[5:]
    with pytest.raises(grpc.RpcError) as e:
        call(msg)
    assert e.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
    assert e.value.details() == oversize_message(len(msg), CAP)
    channel.close()


@pytest.mark.parametrize("which", ["grpcio", "port_h2"])
def test_client_deadline_is_deadline_exceeded(servers, pin, which):
    th, _ = servers
    mod = _client(which, pin)
    with mod.InferenceServerClient(th.grpc_url) as c:
        x = mod.InferInput("X", [1], "INT32")
        x.set_data_from_numpy(np.array([1500], np.int32))
        t0 = time.monotonic()
        status, _ = _err(lambda: c.infer("sleepy", [x], client_timeout=0.3))
        assert status == "StatusCode.DEADLINE_EXCEEDED"
        assert time.monotonic() - t0 < 1.2
        x.set_data_from_numpy(np.array([5], np.int32))
        assert c.infer("sleepy", [x]).as_numpy("Y").tolist() == [5]


def _raw_call(port, headers, body=b"", wait=10.0):
    """One call by hand over the port's HTTP/2 connection: (response
    headers, data, trailers)."""
    conn = h2.H2Connection(client=True)
    conn.initiate()
    with socket.create_connection(("127.0.0.1", port)) as s:
        s.settimeout(wait)
        pseudo = [f for f in headers if f[0].startswith(":")]
        fields = [(":method", "POST"), (":scheme", "http"),
                  (":authority", f"127.0.0.1:{port}")] + pseudo + [
            ("content-type", "application/grpc"), ("te", "trailers")] + [
            f for f in headers if not f[0].startswith(":")]
        if any(k == "content-type" for k, _ in headers):
            fields.remove(("content-type", "application/grpc"))
        conn.send_headers(1, fields)
        conn.send_data(1, body, end_stream=True)
        s.sendall(conn.data_to_send())
        head, data, trailers = {}, b"", {}
        while True:
            chunk = s.recv(1 << 16)
            assert chunk, "connection closed"
            for ev in conn.receive_data(chunk):
                if isinstance(ev, h2.HeadersReceived):
                    (trailers if ev.trailers else head).update(ev.headers)
                    if ev.end_stream and not ev.trailers:
                        trailers = head
                elif isinstance(ev, h2.DataReceived):
                    data += ev.data
                elif isinstance(ev, h2.StreamEnded):
                    return head, data, trailers
                elif isinstance(ev, h2.StreamReset):
                    raise AssertionError(f"stream reset: {ev}")
            s.sendall(conn.data_to_send())


def test_grpc_timeout_is_answered_by_the_server(servers):
    """No deadline on the client's side: the server's own answer."""
    th, _ = servers
    request = tp.ModelInferRequest(model_name="sleepy")
    request.inputs.append(tp.ModelInferRequest.InferInputTensor(
        name="X", datatype="INT32", shape=[1]))
    request.raw_input_contents.append(np.array([2000], np.int32).tobytes())
    t0 = time.monotonic()
    _, _, trailers = _raw_call(
        th.grpc_port, [(":path", "/inference.GRPCInferenceService/"
                        "ModelInfer"), ("grpc-timeout", "200m")],
        encode_frame(request))
    assert trailers["grpc-status"] == "4"
    assert trailers["grpc-message"] == "Deadline Exceeded"
    assert time.monotonic() - t0 < 1.5


def test_unknown_method_and_encoding(servers):
    th, _ = servers
    _, _, t = _raw_call(th.grpc_port, [
        (":path", "/inference.GRPCInferenceService/Nope")])
    assert (t["grpc-status"], t["grpc-message"]) == ("12",
                                                      "Method not found!")
    _, _, t = _raw_call(th.grpc_port, [
        (":path", "/inference.GRPCInferenceService/ServerLive"),
        ("grpc-encoding", "br")], encode_frame(tp.ServerLiveRequest()))
    assert t["grpc-status"] == "12"
    assert t["grpc-message"] == \
        "Compression algorithm 'br' is not supported"
    head, _, _ = _raw_call(th.grpc_port, [
        (":path", "/inference.GRPCInferenceService/ServerLive"),
        ("content-type", "text/plain")])
    assert head[":status"] == "415"


@pytest.mark.parametrize("algorithm", ["gzip", "deflate"])
def test_compressed_requests(servers, pin, algorithm):
    th, jh = servers
    pin("h2")
    a, b = _ab(7)
    arrays = [("INPUT0", "INT32", a), ("INPUT1", "INT32", b)]
    with tgrpc.InferenceServerClient(th.grpc_url) as c:
        r = c.infer("simple", _inputs(tgrpc, arrays),
                    compression_algorithm=algorithm)
        np.testing.assert_array_equal(r.as_numpy("OUTPUT0"), a + b)
    compression = {"gzip": grpc.Compression.Gzip,
                   "deflate": grpc.Compression.Deflate}[algorithm]
    channel = grpc.insecure_channel(th.grpc_url, compression=compression)
    call = channel.unary_unary("/inference.GRPCInferenceService/ModelInfer",
                               request_serializer=lambda m: m,
                               response_deserializer=lambda b: b)
    from triton_client_tpu_torch.grpc._utils import get_inference_request
    msg = encode_frame(get_inference_request(
        "simple", _inputs(tgrpc, arrays), "", "", None, 0, False, False, 0,
        None, None))[5:]
    resp = tp.ModelInferResponse.FromString(call(msg))
    assert np.frombuffer(resp.raw_output_contents[0], np.int32).tolist() \
        == (a + b).reshape(-1).tolist()
    channel.close()


def test_32_async_infers_share_one_connection(servers, pin):
    th, _ = servers
    pin("h2")
    accepted = []
    srv = th._grpc
    orig = srv.process_request

    def count(request, addr):
        accepted.append(addr)
        return orig(request, addr)

    srv.process_request = count
    try:
        with tgrpc.InferenceServerClient(th.grpc_url) as c:
            t0 = time.monotonic()
            futures = []
            for i in range(32):
                x = tgrpc.InferInput("X", [1], "INT32")
                x.set_data_from_numpy(np.array([300 + i], np.int32))
                futures.append(c.async_infer("sleepy", [x]))
            got = [f.get_result().as_numpy("Y").tolist() for f in futures]
            took = time.monotonic() - t0
    finally:
        srv.process_request = orig
    assert got == [[300 + i] for i in range(32)]
    assert len(accepted) == 1
    # served at once (the client's pool runs 16 at a time): far below
    # 32 x 0.3 s
    assert took < 32 * 0.3 / 2


def test_cancelled_stream_cancels_the_call(servers, pin):
    th, _ = servers
    pin("h2")
    got = []
    with tgrpc.InferenceServerClient(th.grpc_url) as c:
        c.start_stream(lambda result, error: got.append((result, error)))
        model, arrays = _repeat(list(range(20)), [200_000] * 20)
        c.async_stream_infer(model, _inputs(tgrpc, arrays))
        time.sleep(0.5)
        c.stop_stream(cancel_requests=True)
    errors = [e for _, e in got if e is not None]
    assert len(errors) == 1
    assert errors[0].status() == "StatusCode.CANCELLED"
    assert len(got) - 1 < 20
    _wait_idle(th)


def test_goaway_on_drain_leaves_no_caller_error(pin):
    pin("h2")
    treg = ModelRegistry()
    treg.register_model(_sleepy())
    with ServerHarness(treg) as h:
        c = tgrpc.InferenceServerClient(h.grpc_url)
        channel = grpc.insecure_channel(h.grpc_url)
        stub = channel.unary_unary(
            "/inference.GRPCInferenceService/ServerLive",
            request_serializer=lambda m: m,
            response_deserializer=lambda b: b)
        stub(b"")  # grpcio's connection is up
        futures = []
        for i in range(4):
            x = tgrpc.InferInput("X", [1], "INT32")
            x.set_data_from_numpy(np.array([1500 + i], np.int32))
            futures.append(c.async_infer("sleepy", [x]))
        end = time.monotonic() + 10
        while h._grpc.active < 4 and time.monotonic() < end:
            time.sleep(0.01)
        assert h._grpc.active == 4  # all four in flight at the GOAWAY
        h._grpc.goaway()
        got = [f.get_result().as_numpy("Y").tolist() for f in futures]
        assert got == [[1500 + i] for i in range(4)]
        # the next calls go on new connections
        x = tgrpc.InferInput("X", [1], "INT32")
        x.set_data_from_numpy(np.array([1], np.int32))
        assert c.infer("sleepy", [x]).as_numpy("Y").tolist() == [1]
        stub(b"")
        c.close()
        channel.close()


@pytest.mark.parametrize("permit", [True, False])
def test_keepalive_options_drive_pings(servers, pin, permit):
    """``keepalive_time_ms`` PINGs, answered by the server; without
    ``keepalive_permit_without_calls`` none while no call is open, and at
    most ``http2_max_pings_without_data`` between two sends."""
    from triton_client_tpu_torch.grpc import _h2_transport
    th, _ = servers
    pin("h2")
    acks = []
    real = _h2_transport._Connection._ping_acked_event

    def count(self):
        acks.append(time.monotonic())
        real(self)

    opts = tgrpc.KeepAliveOptions(
        keepalive_time_ms=100, keepalive_timeout_ms=5000,
        keepalive_permit_without_calls=permit,
        http2_max_pings_without_data=2)
    try:
        _h2_transport._Connection._ping_acked_event = count
        with tgrpc.InferenceServerClient(th.grpc_url,
                                         keepalive_options=opts) as c:
            assert c.is_server_live()
            time.sleep(0.75)
            idle = len(acks)
            x = tgrpc.InferInput("X", [1], "INT32")
            x.set_data_from_numpy(np.array([900], np.int32))
            assert c.infer("sleepy", [x]).as_numpy("Y").tolist() == [900]
    finally:
        _h2_transport._Connection._ping_acked_event = real
    # idle: every 100 ms with the permit, else none; during the 0.9 s
    # call, two (the bound without data), then none until a send
    assert (idle >= 2) if permit else (idle == 0)
    assert 1 <= len(acks) - idle <= 2


# ---------------------------------------------------------------------------
# 12. the probe, the pin and the CLI
# ---------------------------------------------------------------------------

def test_the_probe_picks_the_wire(servers, pin, monkeypatch):
    th, jh = servers
    monkeypatch.delenv("TC_TPU_GRPC_TRANSPORT", raising=False)
    got = {}
    for name, url in (("port grpc", th.grpc_url), ("port http", th.http_url),
                      ("ref grpc", jh.grpc_url), ("ref http", jh.http_url)):
        with tgrpc.InferenceServerClient(url) as c:
            assert c.is_server_live()
            got[name] = c._wire.name
    assert got == {"port grpc": "h2", "port http": "web",
                   "ref grpc": "h2", "ref http": "web"}


def test_a_pinned_wire_is_never_swapped(servers, pin):
    th, _ = servers
    pin("h2")
    with tgrpc.InferenceServerClient(th.http_url) as c:
        status, message = _err(c.is_server_live)
    assert status == "StatusCode.UNAVAILABLE"
    assert "TC_TPU_GRPC_TRANSPORT=h2" in message
    pin("web")
    with tgrpc.InferenceServerClient(th.http_url) as c:
        assert c.is_server_live() and c._wire.name == "web"


def test_an_unreachable_server_pins_nothing(pin, monkeypatch):
    monkeypatch.delenv("TC_TPU_GRPC_TRANSPORT", raising=False)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    treg = ModelRegistry()
    treg.register_model(tzoo.make_simple())
    c = tgrpc.InferenceServerClient(f"127.0.0.1:{port}")
    status, _ = _err(c.is_server_live)
    assert status == "StatusCode.UNAVAILABLE" and c._wire is None
    with ServerHarness(treg, grpc_port=port):
        assert c.is_server_live() and c._wire.name == "h2"
    c.close()


def test_aio_client_picks_the_wire(servers, monkeypatch):
    th, jh = servers
    monkeypatch.delenv("TC_TPU_GRPC_TRANSPORT", raising=False)

    async def main(url):
        async with tgrpc_aio.InferenceServerClient(url) as c:
            a, b = _ab(4)
            r = await c.infer("simple", _inputs(
                tgrpc, [("INPUT0", "INT32", a), ("INPUT1", "INT32", b)]))
            x = tgrpc.InferInput("X", [1], "INT32")
            x.set_data_from_numpy(np.array([2000], np.int32))
            with pytest.raises(InferenceServerException) as e:
                await c.infer("sleepy", [x], client_timeout=0.2)
            return (c._h2 is not None, r.as_numpy("OUTPUT0").tolist(),
                    e.value.status())

    for url, h2_wire in ((th.grpc_url, True), (th.http_url, False)):
        wire, got, status = asyncio.run(main(url))
        a, b = _ab(4)
        assert wire is h2_wire and got == (a + b).tolist()
        assert status == "StatusCode.DEADLINE_EXCEEDED"


def test_cli_serves_grpc_on_its_grpc_port(tmp_path):
    log = tmp_path / "server.log"
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "triton_client_tpu_torch.server",
             "--device", "cpu", "--http-port", "0", "--grpc-port", "0",
             "--metrics-port", "0"], cwd=REPO, stdout=f,
            stderr=subprocess.STDOUT, env=dict(os.environ, PYTHONPATH=REPO))
    try:
        http_port = cli_http_port(proc, str(log))
        grpc_port = cli_grpc_port(proc, str(log))
        assert grpc_port != http_port
        with jgrpc.InferenceServerClient(f"127.0.0.1:{grpc_port}") as c:
            assert c.is_server_ready()
            a, b = _ab(8)
            r = c.infer("simple", _inputs(
                jgrpc, [("INPUT0", "INT32", a), ("INPUT1", "INT32", b)]))
            np.testing.assert_array_equal(r.as_numpy("OUTPUT0"), a + b)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# ---------------------------------------------------------------------------
# the listen backlog of every listener (ROADMAP C12)
# ---------------------------------------------------------------------------

def _listener(kind):
    from triton_client_tpu_torch.server.core import InferenceCore
    from triton_client_tpu_torch.server.grpc_h2 import GrpcH2Server
    from triton_client_tpu_torch.server.http_server import (HttpServer,
                                                            MetricsServer)
    treg = ModelRegistry()
    treg.register_model(tzoo.make_simple())
    core = InferenceCore(treg)
    cls = {"http": HttpServer, "metrics": MetricsServer,
           "grpc": GrpcH2Server}[kind]
    return core, cls(core, "127.0.0.1", 0)


@pytest.mark.parametrize("kind", ["http", "metrics", "grpc"])
def test_listeners_keep_a_backlog_of_128(kind, monkeypatch):
    """The backlog each listener asks of ``listen()``, read as it binds."""
    asked = []
    real = socket.socket.listen

    def listen(self, *args):
        asked.append(args)
        return real(self, *args)

    monkeypatch.setattr(socket.socket, "listen", listen)
    core, srv = _listener(kind)
    try:
        assert asked == [(128,)] and srv.request_queue_size == 128
    finally:
        srv.server_close()
        core.shutdown()


@pytest.mark.parametrize("kind", ["http", "metrics", "grpc"])
def test_64_connects_while_accept_is_held(kind):
    """64 clients connect before the accept loop runs (as when it waits
    for the interpreter lock): each connect completes at once, and each
    connection is then served, none reset.  With the stdlib's backlog of
    5, the seventh connect's SYN is dropped and waits a second."""
    core, srv = _listener(kind)
    port = srv.server_address[1]
    socks = []
    serving = False
    try:
        for _ in range(64):
            socks.append(socket.create_connection(("127.0.0.1", port),
                                                  timeout=0.5))
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        serving = True
        if kind == "grpc":
            ask = h2.PREFACE + b"\0\0\0\x04\0\0\0\0\0"
            want = b"\0\0"  # the server's SETTINGS frame
        else:
            path = "/metrics" if kind == "metrics" else "/v2/health/live"
            ask = f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode()
            want = b"HTTP/1.1 200"
        for s in socks:
            s.settimeout(30)
            s.sendall(ask)
        for s in socks:
            assert s.recv(64).startswith(want)
    finally:
        for s in socks:
            s.close()
        if serving:
            srv.shutdown()
        srv.server_close()
        core.shutdown()


# ---------------------------------------------------------------------------
# the load tools on the gRPC ports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("streaming", [False, True],
                         ids=["unary", "streaming"])
def test_perf_analyzer_over_h2(servers, monkeypatch, tmp_path, capsys,
                               streaming):
    from triton_client_tpu_torch import perf_analyzer as tpa
    th, _ = servers
    monkeypatch.setenv("TC_TPU_GRPC_TRANSPORT", "h2")
    path = tmp_path / "m.json"
    assert tpa.main(["-m", "simple", "-u", th.grpc_url, "-i", "grpc",
                     "--concurrency-range", "2", "--measurement-interval",
                     "300", "--export-metrics", str(path)]
                    + (["--streaming"] if streaming else [])) == 0
    import json
    res = json.loads(path.read_text())["results"][0]
    assert res["errors"] == 0 and res["throughput"] > 0
    capsys.readouterr()


def test_perf_analyzer_cluster_over_h2_ports(monkeypatch, tmp_path, capsys):
    from triton_client_tpu_torch import perf_analyzer as tpa
    from triton_client_tpu_torch.server.testing import ClusterHarness
    monkeypatch.setenv("TC_TPU_GRPC_TRANSPORT", "h2")

    def registry():
        treg = ModelRegistry()
        treg.register_model(tzoo.make_simple())
        return treg

    with ClusterHarness(registry, n=2) as pair:
        assert pair.grpc_urls != pair.grpc_web_urls
        path = tmp_path / "m.json"
        assert tpa.main(["-m", "simple", "-u", ",".join(pair.grpc_urls),
                         "-i", "grpc", "--concurrency-range", "2",
                         "--measurement-interval", "300",
                         "--export-metrics", str(path)]) == 0
        import json
        exported = json.loads(path.read_text())
        assert exported["urls"] == pair.grpc_urls
        res = exported["results"][0]
        assert res["errors"] == 0 and res["throughput"] > 0
        execs = [h.core.statistics("simple")[0]["execution_count"]
                 for h in pair.harnesses]
        assert all(n > 0 for n in execs), execs
    capsys.readouterr()


def test_tools_default_to_the_grpc_port():
    from triton_client_tpu_torch import genai_perf, perf_analyzer
    seen = {}

    def fake(name):
        def run(url, *args, **kwargs):
            seen[name] = url
            raise RuntimeError("stop")
        return run

    import unittest.mock as mock
    with mock.patch.object(genai_perf, "profile", fake("stream")), \
            mock.patch.object(genai_perf, "profile_generate",
                              fake("generate")):
        genai_perf.main(["-m", "llama_decode"])
        genai_perf.main(["-m", "llama_generate", "--endpoint", "generate"])
    assert seen == {"stream": "localhost:8001",
                    "generate": "localhost:8000"}
    src = open(perf_analyzer.__file__).read()
    assert '"localhost:8001" if args.protocol == "grpc"' in src
