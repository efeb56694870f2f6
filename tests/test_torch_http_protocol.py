"""The port's HTTP server at the protocol's edges, against the reference's.

Both packages' in-process servers serve ``simple``; each test sends the same
bytes to both and holds the port to the reference's answer:

* an HTTP/2 preface (``PRI * HTTP/2.0``, what a gRPC client sends first
  when it tries h2c) is answered with an HTTP/1.1 status line and headers,
  then the connection closes, so the native C++ gRPC client falls back to
  gRPC-Web on the HTTP port with no transport pinned (run where
  ``native/client/build/simple_grpc_infer_client`` exists);
* HEAD is served on the GET routes (the GET response's status and
  headers, no body); a path that only another method's route serves gets
  405, an unknown one 404;
* request bodies compressed with gzip or deflate (both packages' HTTP
  clients, ``request_compression_algorithm``) get the reference's answers,
  and the ingress cap counts the inflated bytes;
* ``/v2``'s extensions are the reference's, less those the port does not
  serve (``model_repository*``, ``xla_shared_memory``).
"""

import gzip
import json
import os
import socket
import subprocess
import urllib.request
import zlib

import numpy as np
import pytest

import triton_client_tpu.http as jhttp
from triton_client_tpu.models import zoo as jzoo
from triton_client_tpu.server.core import InferenceCore as JaxCore
from triton_client_tpu.server.registry import ModelRegistry as JaxRegistry
from triton_client_tpu.server.testing import ServerHarness as JaxHarness
import triton_client_tpu_torch.http as thttp
from triton_client_tpu_torch.models import zoo as tzoo
from triton_client_tpu_torch.server.core import InferenceCore
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import ServerHarness

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_GRPC = os.path.join(_REPO, "native", "client", "build",
                           "simple_grpc_infer_client")


@pytest.fixture(scope="module")
def servers():
    jreg = JaxRegistry()
    jreg.register_model(jzoo.make_simple())
    treg = ModelRegistry()
    treg.register_model(tzoo.make_simple())
    with JaxHarness(jreg) as jh, ServerHarness(treg) as th:
        yield th.http_url, jh.http_url


def _raw(url: str, data: bytes) -> bytes:
    """What the server sends back to ``data`` until it closes (or 3 s)."""
    host, port = url.split(":")
    out = b""
    with socket.create_connection((host, int(port)), timeout=3) as s:
        s.sendall(data)
        try:
            while True:
                got = s.recv(65536)
                if not got:
                    break
                out += got
        except socket.timeout:
            pass
    return out


# an HTTP/2 client's first bytes: the preface, then an empty SETTINGS frame
_H2_PREFACE = (b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"
               b"\x00\x00\x00\x04\x00\x00\x00\x00\x00")


def test_http2_preface_gets_an_http1_status_line(servers):
    port, ref = servers
    for url in (port, ref):
        answer = _raw(url, _H2_PREFACE)
        assert answer.startswith(b"HTTP/1."), (url, answer[:80])
        status = int(answer.split(b" ", 2)[1])
        assert 400 <= status < 600
    # the port's answer is a whole HTTP/1.1 response, and then the close
    head, _, body = _raw(port, _H2_PREFACE).partition(b"\r\n\r\n")
    assert head.startswith(b"HTTP/1.1 400")
    assert b"Connection: close" in head
    length = [int(ln.split(b":")[1]) for ln in head.split(b"\r\n")
              if ln.lower().startswith(b"content-length:")]
    assert length == [len(body)]


def test_native_grpc_client_falls_back_to_grpc_web(servers):
    if not os.access(NATIVE_GRPC, os.X_OK):
        pytest.skip("the native client is not built "
                    "(native/client/build/simple_grpc_infer_client)")
    port, _ref = servers
    env = {k: v for k, v in os.environ.items()
           if k != "TC_TPU_GRPC_TRANSPORT"}
    proc = subprocess.run([NATIVE_GRPC, "-u", port], capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PASS" in proc.stdout


def _request(url: str, method: str, path: str, body: bytes = None):
    req = urllib.request.Request(f"http://{url}{path}", data=body,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, dict(resp.getheaders()), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


@pytest.mark.parametrize("path", ["/v2/health/ready", "/v2/health/live",
                                  "/v2", "/v2/models/simple",
                                  "/v2/models/simple/config",
                                  "/v2/models/simple/ready",
                                  "/v2/models/nope"])
def test_head_is_served_on_the_get_routes(servers, path):
    port, ref = servers
    t_status, t_hdr, t_body = _request(port, "HEAD", path)
    j_status, _j_hdr, j_body = _request(ref, "HEAD", path)
    assert t_status == j_status
    assert t_body == j_body == b""
    g_status, _g_hdr, g_body = _request(port, "GET", path)
    assert t_status == g_status
    assert int(t_hdr["Content-Length"]) == len(g_body)


@pytest.mark.parametrize("method,path", [
    ("GET", "/v2/models/simple/infer"),
    ("GET", "/v2/models/simple/generate"),
    ("POST", "/v2/health/ready"),
    ("POST", "/v2/models/simple/config"),
    ("PUT", "/v2/models/simple/infer"),
    ("DELETE", "/v2/health/live"),
    ("OPTIONS", "/v2"),
    ("GET", "/v2/no/such/route"),
    ("OPTIONS", "/v2/no/such/route"),
])
def test_wrong_method_gets_the_reference_status(servers, method, path):
    port, ref = servers
    body = b"{}" if method in ("POST", "PUT") else None
    t_status, t_hdr, _ = _request(port, method, path, body)
    j_status, _, _ = _request(ref, method, path, body)
    assert t_status == j_status
    if t_status == 405:
        assert method not in t_hdr["Allow"].split(", ")


def _simple_inputs(mod):
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    b = np.full((1, 16), 3, dtype=np.int32)
    ins = [mod.InferInput("INPUT0", [1, 16], "INT32"),
           mod.InferInput("INPUT1", [1, 16], "INT32")]
    ins[0].set_data_from_numpy(a)
    ins[1].set_data_from_numpy(b)
    return ins, a + b, a - b


@pytest.mark.parametrize("algorithm", ["gzip", "deflate"])
@pytest.mark.parametrize("client", ["port", "reference"])
def test_compressed_request_bodies(servers, algorithm, client):
    mod = thttp if client == "port" else jhttp
    answers = []
    for url in servers:
        ins, want0, want1 = _simple_inputs(mod)
        with mod.InferenceServerClient(url) as c:
            res = c.infer("simple", ins,
                          request_compression_algorithm=algorithm)
        np.testing.assert_array_equal(res.as_numpy("OUTPUT0"), want0)
        np.testing.assert_array_equal(res.as_numpy("OUTPUT1"), want1)
        answers.append((res.as_numpy("OUTPUT0").tolist(),
                        res.as_numpy("OUTPUT1").tolist()))
    assert answers[0] == answers[1]


def _json_infer_body():
    return json.dumps({"inputs": [
        {"name": "INPUT0", "datatype": "INT32", "shape": [1, 16],
         "data": list(range(16))},
        {"name": "INPUT1", "datatype": "INT32", "shape": [1, 16],
         "data": [1] * 16}]}).encode()


@pytest.mark.parametrize("encoding,compress", [
    ("gzip", gzip.compress),
    ("deflate", zlib.compress),
    ("deflate", lambda b: zlib.compress(b)[2:-4]),     # raw deflate
])
def test_compressed_json_body_as_reference(servers, encoding, compress):
    answers = []
    for url in servers:
        req = urllib.request.Request(
            f"http://{url}/v2/models/simple/infer",
            data=compress(_json_infer_body()),
            headers={"Content-Encoding": encoding,
                     "Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            out = json.loads(resp.read())
        answers.append([o["data"] for o in out["outputs"]])
    assert answers[0] == answers[1]
    assert answers[0][0] == [i + 1 for i in range(16)]


def test_ingress_cap_counts_inflated_bytes():
    """A gzip body far under the cap that inflates past it is refused
    with the 413 of a body sent that large; one that inflates under it is
    served, and a corrupt one is a 400."""
    reg = ModelRegistry()
    reg.register_model(tzoo.make_simple())
    with ServerHarness(reg) as h:
        h._server.max_request_bytes = 4096
        big = json.dumps({"inputs": [], "pad": "x" * 20000}).encode()
        for body, want in ((gzip.compress(big), 413),
                           (gzip.compress(_json_infer_body()), 200),
                           (b"\x1f\x8b not gzip", 400)):
            assert len(body) < 4096
            status, hdr, _ = _post_encoded(h.http_url, body)
            assert status == want, (status, want)
            if want == 413:
                assert hdr["triton-max-request-bytes"] == "4096"


def _post_encoded(url, body):
    req = urllib.request.Request(
        f"http://{url}/v2/models/simple/infer", data=body,
        headers={"Content-Encoding": "gzip"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, dict(resp.getheaders()), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_extensions_are_the_reference_less_unported(servers):
    unported = {"model_repository", "model_repository(unload_dependents)",
                "xla_shared_memory"}
    want = [e for e in JaxCore.EXTENSIONS if e not in unported]
    assert InferenceCore.EXTENSIONS == want
    port, ref = servers
    with urllib.request.urlopen(f"http://{port}/v2", timeout=30) as r:
        served = json.loads(r.read())["extensions"]
    with urllib.request.urlopen(f"http://{ref}/v2", timeout=30) as r:
        ref_served = json.loads(r.read())["extensions"]
    assert served == [e for e in ref_served if e not in unported]
