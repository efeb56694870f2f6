"""Compression in the port, against the reference's, on the CPU.

* Responses: the HTTP frontend gzips an infer response over 1,024 bytes
  where the request's ``Accept-Encoding`` names gzip, and only then
  (``deflate`` is never used for a response), as the reference's does
  (``triton_client_tpu/server/http_server.py:737-741``): a response of
  exactly 1,024 bytes and one of 1,025, each made to that size on each
  package's own server through the request id it echoes, read with the
  same headers from both; a gzipped body inflates to the plain one.
* gRPC-Web requests: a frame with flag bit 0x01 in the call's
  ``grpc-encoding`` (gzip, deflate) is inflated, unary and on a stream;
  the sync and aio clients' ``compression_algorithm`` answers equal the
  plain ones and the reference's gRPC client's with the same argument; an
  unknown encoding is UNIMPLEMENTED; a frame that inflates past the ingress
  cap is refused as an HTTP body that does (C5): RESOURCE_EXHAUSTED on a
  unary call, an in-band ``[413]`` on a stream.
"""

import asyncio
import gzip
import http.client
import json
import struct
import threading
import zlib

import numpy as np
import pytest

import triton_client_tpu.grpc as jgrpc
from triton_client_tpu.models import zoo as jzoo
from triton_client_tpu.server.registry import ModelRegistry as JaxRegistry
from triton_client_tpu.server.testing import ServerHarness as JaxHarness
import triton_client_tpu_torch.grpc as tgrpc
from triton_client_tpu_torch.grpc import aio as tgrpc_aio
from triton_client_tpu_torch.grpc._utils import get_inference_request
from triton_client_tpu_torch.models import zoo as tzoo
from triton_client_tpu_torch.protocol import inference as tp
from triton_client_tpu_torch.protocol.grpc_web import (compress_frame,
                                                       encode_frame,
                                                       iter_frames,
                                                       parse_trailer_fields)
from triton_client_tpu_torch.server.core import InferenceCore
from triton_client_tpu_torch.server.http_server import HttpServer
from triton_client_tpu_torch.server.memory import oversize_message
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import ServerHarness

MODEL = "custom_identity_int32"
#: the ingress cap of the cap tests' server
CAP = 4096


@pytest.fixture(scope="module")
def servers():
    """(port harness, reference harness), both serving ``simple`` and
    ``custom_identity_int32``."""
    jreg = JaxRegistry()
    treg = ModelRegistry()
    for name in ("simple", "custom_identity_int32"):
        jreg.register_model(getattr(jzoo, f"make_{name}")())
        treg.register_model(getattr(tzoo, f"make_{name}")())
    with ServerHarness(treg) as th, JaxHarness(jreg) as jh:
        yield th, jh


def _post_identity(url: str, n: int, rid: str, accept: str = ""):
    """One binary infer of ``n`` INT32 through the identity model, its
    output binary: (status, headers, body as sent)."""
    body = json.dumps({
        "id": rid,
        "inputs": [{"name": "INPUT0", "datatype": "INT32", "shape": [1, n],
                    "parameters": {"binary_data_size": 4 * n}}],
        "outputs": [{"name": "OUTPUT0",
                     "parameters": {"binary_data": True}}]}).encode()
    headers = {"Inference-Header-Content-Length": str(len(body))}
    if accept:
        headers["Accept-Encoding"] = accept
    conn = http.client.HTTPConnection(url, timeout=30)
    try:
        conn.request("POST", f"/v2/models/{MODEL}/infer",
                     body + np.arange(n, dtype=np.int32).tobytes(), headers)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _id_for_size(url: str, n: int, size: int) -> str:
    """A request id with which this server's plain answer is ``size``
    bytes long (the header echoes the id)."""
    base = len(_post_identity(url, n, "x")[2])
    assert base <= size, (base, size)
    return "x" * (1 + size - base)


@pytest.mark.parametrize("size,compressed", [(1024, False), (1025, True)])
def test_gzip_only_over_1024_bytes(servers, size, compressed):
    got = {}
    for name, h in zip(("port", "ref"), servers):
        rid = _id_for_size(h.http_url, 200, size)
        status, plain_headers, plain = _post_identity(h.http_url, 200, rid)
        assert status == 200 and len(plain) == size
        status, headers, body = _post_identity(h.http_url, 200, rid, "gzip")
        assert status == 200
        encoding = headers.get("Content-Encoding")
        got[name] = (encoding, headers["Inference-Header-Content-Length"])
        assert (gzip.decompress(body) if encoding == "gzip" else body) \
            == plain
    assert got["port"] == got["ref"]
    assert (got["port"][0] == "gzip") == compressed


@pytest.mark.parametrize("accept", ["deflate", "identity", "br, deflate"])
def test_no_gzip_unless_asked(servers, accept):
    """A large response goes back plain unless gzip is accepted: deflate
    is never used for a response, in both packages."""
    for h in servers:
        status, headers, body = _post_identity(h.http_url, 2048, "", accept)
        assert status == 200 and "Content-Encoding" not in headers
        assert len(body) > 8192


def test_gzipped_response_through_the_port_client(servers):
    """The port's sync client asks for gzip and reads the same arrays."""
    import triton_client_tpu_torch.http as thttp

    x = np.arange(4096, dtype=np.int32).reshape(1, -1)
    with thttp.InferenceServerClient(servers[0].http_url) as c:
        i = thttp.InferInput("INPUT0", list(x.shape), "INT32")
        i.set_data_from_numpy(x)
        out = thttp.InferRequestedOutput("OUTPUT0", binary_data=True)
        plain = c.infer(MODEL, [i], outputs=[out])
        gz = c.infer(MODEL, [i], outputs=[out],
                     response_compression_algorithm="gzip")
    assert plain.get_response() == gz.get_response()
    np.testing.assert_array_equal(gz.as_numpy("OUTPUT0"), x)


# ---------------------------------------------------------------------------
# gRPC-Web request frames
# ---------------------------------------------------------------------------

def _simple_request(seed=3):
    rng = np.random.default_rng(seed)
    a = rng.integers(-100, 100, (1, 16)).astype(np.int32)
    b = rng.integers(-100, 100, (1, 16)).astype(np.int32)
    return a, b


def _inputs(mod, a, b):
    ins = [mod.InferInput("INPUT0", [1, 16], "INT32"),
           mod.InferInput("INPUT1", [1, 16], "INT32")]
    ins[0].set_data_from_numpy(a)
    ins[1].set_data_from_numpy(b)
    return ins


def _grpc_web(url, method, body: bytes, headers=None):
    """A raw gRPC-Web call: (data frames, status, message)."""
    conn = http.client.HTTPConnection(url, timeout=30)
    try:
        conn.request("POST", f"/inference.GRPCInferenceService/{method}",
                     body, {"Content-Type": "application/grpc-web+proto",
                            **(headers or {})})
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    frames = list(iter_frames([data]))
    status, message, _ = parse_trailer_fields(
        [p for f, p in frames if f & 0x80][-1])
    return [bytes(p) for f, p in frames if not f & 0x80], status, message


@pytest.mark.parametrize("encoding", ["gzip", "deflate"])
def test_compressed_frames_are_inflated(servers, encoding):
    th, _ = servers
    a, b = _simple_request()
    frame = encode_frame(get_inference_request(
        "simple", _inputs(tgrpc, a, b), "", "r1", None, 0, False, False, 0,
        None, None))
    plain = _grpc_web(th.http_url, "ModelInfer", frame)
    packed = compress_frame(frame, encoding)
    assert packed[0] == 1 and packed != frame
    got = _grpc_web(th.http_url, "ModelInfer", packed,
                    {"grpc-encoding": encoding})
    assert got == plain and int(got[1]) == 0


@pytest.mark.parametrize("algorithm", ["gzip", "deflate"])
def test_client_compression_answers_equal_the_reference(servers, algorithm):
    """The port's sync unary and stream, and its aio unary, under
    ``compression_algorithm``; the reference's gRPC client with the same
    argument to its HTTP/2 port."""
    th, jh = servers
    a, b = _simple_request(5)
    with jgrpc.InferenceServerClient(f"127.0.0.1:{jh.grpc_port}") as c:
        want = c.infer("simple", _inputs(jgrpc, a, b),
                       compression_algorithm=algorithm).as_numpy("OUTPUT0")
    with tgrpc.InferenceServerClient(th.http_url) as c:
        unary = c.infer("simple", _inputs(tgrpc, a, b),
                        compression_algorithm=algorithm).as_numpy("OUTPUT0")
        answers = []
        done = threading.Event()

        def callback(result, error):
            answers.append((result, error))
            done.set()

        c.start_stream(callback, compression_algorithm=algorithm)
        c.async_stream_infer("simple", _inputs(tgrpc, a, b))
        assert done.wait(30)
        c.stop_stream()
    assert answers[0][1] is None

    async def aio():
        async with tgrpc_aio.InferenceServerClient(th.http_url) as c:
            return (await c.infer("simple", _inputs(tgrpc, a, b),
                                  compression_algorithm=algorithm)
                    ).as_numpy("OUTPUT0")

    for got in (unary, answers[0][0].as_numpy("OUTPUT0"), asyncio.run(aio())):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, a + b)


def test_unknown_algorithm_is_refused_by_the_client(servers):
    with tgrpc.InferenceServerClient(servers[0].http_url) as c:
        with pytest.raises(Exception, match="unsupported compression"):
            c.infer("simple", _inputs(tgrpc, *_simple_request()),
                    compression_algorithm="snappy")


def test_unknown_grpc_encoding_is_unimplemented(servers):
    th, _ = servers
    frame = encode_frame(tp.ServerLiveRequest())
    data, status, message = _grpc_web(th.http_url, "ServerLive", frame,
                                      {"grpc-encoding": "snappy"})
    assert data == [] and int(status) == 12  # UNIMPLEMENTED
    assert message == "Compression algorithm 'snappy' is not supported"


def test_compressed_frame_without_an_encoding_is_internal(servers):
    th, _ = servers
    packed = compress_frame(encode_frame(tp.ServerLiveRequest()), "gzip")
    _, status, message = _grpc_web(th.http_url, "ServerLive", packed)
    assert int(status) == 13 and "grpc-encoding" in message


@pytest.fixture
def capped():
    """A port server whose ingress cap is CAP bytes."""
    treg = ModelRegistry()
    treg.register_model(tzoo.make_simple())
    treg.register_model(tzoo.make_custom_identity_int32())
    core = InferenceCore(treg)
    srv = HttpServer(core, "127.0.0.1", 0, max_request_bytes=CAP)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    core.shutdown()


def _big_frame():
    """A ModelInfer frame of 16 KiB of zeros: 4x the cap plain, a few
    hundred bytes compressed."""
    x = np.zeros((1, 4096), np.int32)
    i = tgrpc.InferInput("INPUT0", [1, 4096], "INT32")
    i.set_data_from_numpy(x)
    return encode_frame(get_inference_request(
        MODEL, [i], "", "", None, 0, False, False, 0, None, None))


@pytest.mark.parametrize("encoding", ["gzip", "deflate"])
def test_inflated_frame_over_the_cap_is_refused_as_a_body_is(capped,
                                                              encoding):
    """Unary: RESOURCE_EXHAUSTED with the cap's text at the inflated size
    where it stopped (cap + 1), as a compressed HTTP body over the cap
    gets its 413 with the same text; the plain frame is refused before it
    is read, by its declared size."""
    frame = _big_frame()
    packed = compress_frame(frame, encoding)
    assert len(packed) < CAP < len(frame)
    _, status, message = _grpc_web(capped, "ModelInfer", packed,
                                   {"grpc-encoding": encoding})
    assert int(status) == 8  # RESOURCE_EXHAUSTED
    assert message == oversize_message(CAP + 1, CAP)
    _, status, message = _grpc_web(capped, "ModelInfer", frame)
    assert int(status) == 8
    assert message == oversize_message(len(frame), CAP)
    body = json.dumps({"inputs": [{
        "name": "INPUT0", "datatype": "INT32", "shape": [1, 4096],
        "data": [0] * 4096}]}).encode()
    conn = http.client.HTTPConnection(capped, timeout=30)
    try:
        conn.request("POST", f"/v2/models/{MODEL}/infer",
                     gzip.compress(body) if encoding == "gzip"
                     else zlib.compress(body),
                     {"Content-Encoding": encoding})
        resp = conn.getresponse()
        assert resp.status == 413
        assert json.loads(resp.read())["error"] == oversize_message(
            CAP + 1, CAP)
    finally:
        conn.close()


def test_inflated_frame_over_the_cap_on_a_stream_is_in_band(capped):
    """On a stream the refusal is that request's in-band ``[413]``; the
    stream goes on and answers the next request."""
    packed = compress_frame(_big_frame(), "gzip")
    a, b = _simple_request()
    small = compress_frame(encode_frame(get_inference_request(
        "simple", _inputs(tgrpc, a, b), "", "", None, 0, False, False, 0,
        None, None)), "gzip")
    data, status, _ = _grpc_web(capped, "ModelStreamInfer", packed + small,
                                {"grpc-encoding": "gzip"})
    assert int(status) == 0 and len(data) == 2
    first = tp.ModelStreamInferResponse.FromString(data[0])
    assert first.error_message == "[413] " + oversize_message(CAP + 1, CAP)
    second = tp.ModelStreamInferResponse.FromString(data[1])
    assert not second.error_message
    out = second.infer_response.raw_output_contents[0]
    np.testing.assert_array_equal(
        np.frombuffer(out, np.int32).reshape(1, 16), a + b)


def test_frame_header_is_the_grpc_one():
    """A compressed frame: flag 1, then the compressed length big-endian."""
    frame = encode_frame(tp.ServerLiveRequest())
    packed = compress_frame(frame, "gzip")
    flags, n = struct.unpack(">BI", packed[:5])
    assert flags == 1 and n == len(packed) - 5
    assert gzip.decompress(packed[5:]) == frame[5:]
