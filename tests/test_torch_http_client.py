"""The port's v2 HTTP client (``triton_client_tpu_torch.http``) against the
JAX package's (``triton_client_tpu.http``), on the CPU.

* Kept-alive requests: 50 requests of ``simple`` on one connection, through
  the port's client and through the reference's, against the port's
  server: the median under 20 ms (a server that writes a response in more
  than one write without TCP_NODELAY waits ~40 ms for the client's delayed
  ACK on each), and the server's accepted socket has TCP_NODELAY set.
* ``generate_request_body`` byte for byte equal to the reference's for the
  same inputs (JSON and binary, BYTES, BF16, shared-memory parameters,
  request id, parameters, requested outputs); ``parse_response_body`` gives
  equal arrays, gzip and deflate included.
* Across packages: the port's client against the JAX server and the
  reference's client against the port's server give the same answers on
  ``simple`` (exactly), the tiny ``longctx_tpu`` (within 5e-2, the bf16
  logit bound of test_torch_transformer.py, as test_torch_shm.py holds it;
  the reference's seed-11 weights carried to the port as numpy arrays) and
  over system and CUDA shared memory (``device="cpu"`` regions for the
  port's server, the JAX package's regions for its own).
* ``async_infer`` with 16 in flight, the prepared fast path, and the error
  paths: an unknown model, a bad shape, a kept-alive connection the server
  closed (reopened, the request sent once), no server at all, and the
  parameters whose machinery is not ported.
"""

import gzip
import json
import socket
import statistics
import time
import uuid
import zlib

import ml_dtypes
import numpy as np
import pytest

import jax

import triton_client_tpu.utils.shared_memory as jsys
import triton_client_tpu.utils.xla_shared_memory as jcuda
from triton_client_tpu import http as jhttp
from triton_client_tpu.models import language as jlang
from triton_client_tpu.models import transformer as jtr
from triton_client_tpu.models import zoo as jzoo
from triton_client_tpu.server.registry import ModelRegistry as JaxRegistry
from triton_client_tpu.server.testing import ServerHarness as JaxHarness
from triton_client_tpu_torch import http as thttp
from triton_client_tpu_torch.models import language as tlang
from triton_client_tpu_torch.models import zoo as tzoo
from triton_client_tpu_torch.server import http_server as ths
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import ServerHarness, free_port
from triton_client_tpu_torch.utils import InferenceServerException
import triton_client_tpu_torch.utils.cuda_shared_memory as tcuda
import triton_client_tpu_torch.utils.shared_memory as tsys

S = 512  # the tiny longctx_tpu preset's window
PACKAGES = {"port": thttp, "jax": jhttp}


@pytest.fixture(scope="module")
def servers():
    jreg = JaxRegistry()
    jreg.register_model(jzoo.make_simple())
    jreg.register_model(jlang.make_longctx_tpu())
    np_params = {k: np.asarray(v) for k, v in jtr.init_params(
        jax.random.PRNGKey(11), jlang.longctx_cfg()).items()}
    treg = ModelRegistry()
    treg.register_model(tzoo.make_simple())
    treg.register_model(tlang.make_longctx_tpu("cpu", params=np_params))
    with JaxHarness(jreg) as jh, ServerHarness(treg) as th:
        yield jh, th


@pytest.fixture
def accepted(monkeypatch):
    """The TCP_NODELAY option of every socket the port's server accepts
    from here on, in order."""
    seen = []
    setup = ths._Handler.setup

    def record(self):
        setup(self)
        seen.append(self.connection.getsockopt(socket.IPPROTO_TCP,
                                               socket.TCP_NODELAY))

    monkeypatch.setattr(ths._Handler, "setup", record)
    return seen


def _simple_inputs(mod, a, b, binary=True):
    ins = [mod.InferInput("INPUT0", [1, 16], "INT32"),
           mod.InferInput("INPUT1", [1, 16], "INT32")]
    ins[0].set_data_from_numpy(a, binary_data=binary)
    ins[1].set_data_from_numpy(b, binary_data=binary)
    return ins


def _ab(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-1000, 1000, (1, 16)).astype(np.int32),
            rng.integers(-1000, 1000, (1, 16)).astype(np.int32))


# ---------------------------------------------------------------------------
# kept-alive connections (the server's TCP_NODELAY)
# ---------------------------------------------------------------------------

def test_keepalive_latency(servers, accepted):
    _, th = servers
    a, b = _ab(1)
    for name, mod in PACKAGES.items():
        before = len(accepted)
        client = mod.InferenceServerClient(th.http_url)
        try:
            inputs = _simple_inputs(mod, a, b)
            client.infer("simple", inputs)  # warm-up: opens the connection
            lat = []
            for _ in range(50):
                t0 = time.perf_counter()
                res = client.infer("simple", inputs)
                lat.append(time.perf_counter() - t0)
            np.testing.assert_array_equal(res.as_numpy("OUTPUT0"), a + b)
        finally:
            client.close()
        median_ms = 1e3 * statistics.median(lat)
        assert len(accepted) - before == 1, (name, accepted)
        assert median_ms < 20.0, f"{name} client: median {median_ms:.2f} ms"
    assert accepted and all(accepted), accepted


# ---------------------------------------------------------------------------
# request and response bodies
# ---------------------------------------------------------------------------

def _bodies(mod):
    """The same requests built with package ``mod``: (name, inputs,
    keyword arguments of generate_request_body)."""
    rng = np.random.default_rng(5)
    i32 = rng.integers(-9, 9, (2, 3)).astype(np.int32)
    f32 = rng.standard_normal((2, 4)).astype(np.float32)
    bf = rng.standard_normal((3, 2)).astype(ml_dtypes.bfloat16)
    words = np.array([[b"alpha", b""], ["beta", b"\x80\xff"]],
                     dtype=np.object_)
    text = np.array(["uno", "dos", "tres"], dtype=np.object_)

    def inp(name, arr, datatype, binary=True):
        x = mod.InferInput(name, list(arr.shape), datatype)
        x.set_data_from_numpy(arr, binary_data=binary)
        return x

    def out(name, **kw):
        return mod.InferRequestedOutput(name, **kw)

    shm_in = mod.InferInput("S", [2, 3], "INT32")
    shm_in.set_shared_memory("region_in", 24, offset=8)
    shm_out = out("O").set_shared_memory("region_out", 64)
    return [
        ("binary", [inp("A", i32, "INT32"), inp("B", f32, "FP32")], {}),
        ("json", [inp("A", i32, "INT32", False),
                  inp("B", f32, "FP32", False)], {}),
        ("mixed", [inp("A", i32, "INT32"), inp("B", f32, "FP32", False)],
         {"outputs": [out("X"), out("Y", binary_data=False),
                      out("Z", class_count=3)]}),
        ("bytes binary", [inp("W", words, "BYTES")], {}),
        ("bytes json", [inp("T", text, "BYTES", False)], {}),
        ("bf16", [inp("H", bf, "BF16"),
                  inp("G", bf.astype(np.float32), "BF16")], {}),
        ("shm", [shm_in, inp("A", i32, "INT32")],
         {"outputs": [shm_out, out("P")]}),
        ("request id and parameters", [inp("A", i32, "INT32")],
         {"request_id": "req-7", "parameters": {"k": "v", "n": 3},
          "priority": 2, "timeout": 1500}),
        ("sequence", [inp("A", i32, "INT32")],
         {"sequence_id": 42, "sequence_start": True, "request_id": "s"}),
    ]


@pytest.mark.parametrize("case", [c[0] for c in _bodies(thttp)])
def test_request_body_matches_reference(case):
    (_, t_in, t_kw), = [c for c in _bodies(thttp) if c[0] == case]
    (_, j_in, j_kw), = [c for c in _bodies(jhttp) if c[0] == case]
    t_body, t_len = thttp.InferenceServerClient.generate_request_body(
        t_in, **t_kw)
    j_body, j_len = jhttp.InferenceServerClient.generate_request_body(
        j_in, **j_kw)
    assert (t_body, t_len) == (j_body, j_len)
    # the prepared template stamps the same bytes
    if all(i._data is None for i in t_in) and "sequence_id" not in t_kw:
        tpl = thttp.InferenceServerClient("localhost:1").prepare(
            "m", t_in, outputs=t_kw.get("outputs"),
            priority=t_kw.get("priority", 0), timeout=t_kw.get("timeout"),
            parameters=t_kw.get("parameters")).template
        assert tpl.stamp(t_kw.get("request_id", "")) == (j_body, j_len)


def test_reserved_parameter_is_refused_as_in_the_reference():
    for mod in PACKAGES.values():
        x = mod.InferInput("A", [1], "INT32")
        x.set_data_from_numpy(np.zeros(1, np.int32))
        with pytest.raises(Exception, match="reserved parameter") as err:
            mod.InferenceServerClient.generate_request_body(
                [x], parameters={"priority": 1})
        assert type(err.value).__name__ == "InferenceServerException"


def _response_body():
    """A v2 response with binary INT32, BYTES and BF16 outputs and JSON
    FP32 and BYTES ones."""
    i32 = np.arange(6, dtype=np.int32).reshape(2, 3)
    words = np.array([b"a", b"\x80bc"], dtype=np.object_)
    bf = np.linspace(-1, 1, 4).astype(ml_dtypes.bfloat16)
    from triton_client_tpu_torch.utils import serialize_byte_tensor_raw
    raws = [i32.tobytes(), bytes(serialize_byte_tensor_raw(words)),
            bf.tobytes()]
    header = json.dumps({"model_name": "m", "outputs": [
        {"name": "I", "datatype": "INT32", "shape": [2, 3],
         "parameters": {"binary_data_size": len(raws[0])}},
        {"name": "W", "datatype": "BYTES", "shape": [2],
         "parameters": {"binary_data_size": len(raws[1])}},
        {"name": "H", "datatype": "BF16", "shape": [2, 2],
         "parameters": {"binary_data_size": len(raws[2])}},
        {"name": "F", "datatype": "FP32", "shape": [3],
         "data": [0.5, -1.25, 3.0]},
        {"name": "T", "datatype": "BYTES", "shape": [1], "data": ["zz"]},
        {"name": "R", "datatype": "INT32", "shape": [4],
         "parameters": {"shared_memory_region": "r",
                        "shared_memory_byte_size": 16}},
    ]}).encode()
    return header + b"".join(raws), len(header)


@pytest.mark.parametrize("encoding", [None, "gzip", "deflate"])
def test_response_parsing_matches_reference(encoding):
    body, hlen = _response_body()
    if encoding == "gzip":
        body = gzip.compress(body)
    elif encoding == "deflate":
        body = zlib.compress(body)
    t = thttp.InferenceServerClient.parse_response_body(
        body, header_length=hlen, content_encoding=encoding)
    j = jhttp.InferenceServerClient.parse_response_body(
        body, header_length=hlen, content_encoding=encoding)
    assert t.get_response() == j.get_response()
    for name in ("I", "W", "H", "F", "T", "R", "absent"):
        got, want = t.as_numpy(name), j.as_numpy(name)
        if want is None:
            assert got is None, name
            continue
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want)
        assert t.get_output(name) == j.get_output(name)


# ---------------------------------------------------------------------------
# each client against the other package's server
# ---------------------------------------------------------------------------

def _infer_simple(mod, url, a, b, binary):
    with mod.InferenceServerClient(url) as client:
        assert client.is_server_live() and client.is_server_ready()
        assert client.is_model_ready("simple")
        assert not client.is_model_ready("no_such_model")
        res = client.infer("simple", _simple_inputs(mod, a, b, binary),
                           outputs=[mod.InferRequestedOutput(
                               "OUTPUT0", binary_data=binary),
                               mod.InferRequestedOutput("OUTPUT1")])
        meta = client.get_model_metadata("simple")
        return ({n: res.as_numpy(n) for n in ("OUTPUT0", "OUTPUT1")},
                meta["inputs"], meta["outputs"])


@pytest.mark.parametrize("binary", [True, False])
def test_simple_across_packages(servers, binary):
    jh, th = servers
    a, b = _ab(2)
    got = _infer_simple(thttp, jh.http_url, a, b, binary)
    want = _infer_simple(jhttp, th.http_url, a, b, binary)
    for name in ("OUTPUT0", "OUTPUT1"):
        np.testing.assert_array_equal(got[0][name], want[0][name])
    np.testing.assert_array_equal(got[0]["OUTPUT0"], a + b)
    np.testing.assert_array_equal(got[0]["OUTPUT1"], a - b)
    assert got[1:] == want[1:]


def _infer_longctx(mod, url, tokens, compression=None):
    with mod.InferenceServerClient(url) as client:
        x = mod.InferInput("TOKENS", list(tokens.shape), "INT32")
        x.set_data_from_numpy(tokens)
        return client.infer(
            "longctx_tpu", [x],
            response_compression_algorithm=compression).as_numpy("LOGPROBS")


def test_longctx_across_packages(servers):
    jh, th = servers
    tokens = np.random.default_rng(3).integers(0, 256, (2, S)).astype(
        np.int32)
    # the JAX server gzips a response when asked: the port's client
    # decodes it
    got = _infer_longctx(thttp, jh.http_url, tokens, compression="gzip")
    want = _infer_longctx(jhttp, th.http_url, tokens)
    assert got.shape == want.shape == (2, S)
    assert np.isfinite(got).all() and (got[:, -1] == 0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)
    # and each client reads its own package's server the same way
    np.testing.assert_array_equal(_infer_longctx(thttp, th.http_url, tokens),
                                  want)


def _shm_simple(mod, url, kind, package, a, b):
    """simple with both inputs and both outputs in regions of ``package``,
    registered through client module ``mod``; returns the outputs and the
    status lists before and after unregister."""
    made = []
    client = mod.InferenceServerClient(url)
    try:
        def region(name, size):
            if kind == "system":
                smod = tsys if package == "port" else jsys
                key = f"/tcthttp_{uuid.uuid4().hex[:12]}"
                h = smod.create_shared_memory_region(name, key, size)
                client.register_system_shared_memory(name, key, size)
            else:
                smod = tcuda if package == "port" else jcuda
                h = (tcuda.create_shared_memory_region(name, size, 0,
                                                       device="cpu")
                     if package == "port"
                     else jcuda.create_shared_memory_region(name, size, 0))
                client.register_cuda_shared_memory(
                    name, smod.get_raw_handle(h), 0, size)
            made.append((smod, h))
            return smod, h

        ins, outs, handles = [], [], {}
        for name, arr in (("INPUT0", a), ("INPUT1", b)):
            smod, h = region("in_" + name, arr.nbytes)
            smod.set_shared_memory_region(h, [arr])
            x = mod.InferInput(name, [1, 16], "INT32")
            x.set_shared_memory("in_" + name, arr.nbytes)
            ins.append(x)
        for name in ("OUTPUT0", "OUTPUT1"):
            handles[name] = region("out_" + name, 64)
            outs.append(mod.InferRequestedOutput(name).set_shared_memory(
                "out_" + name, 64))
        res = client.infer("simple", ins, outputs=outs)
        assert res.as_numpy("OUTPUT0") is None  # the data lies in regions
        got = {n: np.array(smod.get_contents_as_numpy(h, np.int32, [1, 16]))
               for n, (smod, h) in handles.items()}
        status = (client.get_system_shared_memory_status if kind == "system"
                  else client.get_cuda_shared_memory_status)
        before = status()
        if kind == "system":
            client.unregister_system_shared_memory()
        else:
            client.unregister_cuda_shared_memory()
        return got, len(before), status()
    finally:
        for smod, h in made:
            smod.destroy_shared_memory_region(h)
        client.close()


@pytest.mark.parametrize("kind", ["system", "cuda"])
def test_shm_across_packages(servers, kind):
    jh, th = servers
    a, b = _ab(4)
    got = _shm_simple(thttp, jh.http_url, kind, "jax", a, b)
    want = _shm_simple(jhttp, th.http_url, kind, "port", a, b)
    for name in ("OUTPUT0", "OUTPUT1"):
        np.testing.assert_array_equal(got[0][name], want[0][name])
    np.testing.assert_array_equal(got[0]["OUTPUT0"], a + b)
    assert got[1:] == want[1:] == (4, [])
    assert tsys.mapped_shared_memory_regions() == []
    assert tcuda.allocated_shared_memory_regions() == []
    assert jcuda.allocated_shared_memory_regions() == []


# ---------------------------------------------------------------------------
# async, the fast path, errors
# ---------------------------------------------------------------------------

def test_async_infer_16_in_flight(servers, accepted):
    _, th = servers
    pairs = [_ab(100 + i) for i in range(16)]
    with thttp.InferenceServerClient(th.http_url, concurrency=16) as client:
        handles = [client.async_infer("simple", _simple_inputs(thttp, a, b))
                   for a, b in pairs]
        results = [h.get_result(timeout=60) for h in handles]
    for (a, b), res in zip(pairs, results):
        np.testing.assert_array_equal(res.as_numpy("OUTPUT0"), a + b)
        np.testing.assert_array_equal(res.as_numpy("OUTPUT1"), a - b)
    assert 1 <= len(accepted) <= 16


def test_prepared_request_restamps_data(servers):
    _, th = servers
    with thttp.InferenceServerClient(th.http_url) as client:
        a, b = _ab(6)
        ins = _simple_inputs(thttp, a, b)
        prep = client.prepare("simple", ins)
        for seed in (7, 8):
            a, b = _ab(seed)
            ins[0].set_data_from_numpy(a)
            ins[1].set_data_from_numpy(b)
            res = prep.infer(request_id=f"r{seed}")
            np.testing.assert_array_equal(res.as_numpy("OUTPUT0"), a + b)
            assert res.get_response()["id"] == f"r{seed}"
        ins[0].set_shape([2, 8])
        with pytest.raises(InferenceServerException, match="re-prepare"):
            prep.infer()


@pytest.mark.parametrize("case", ["unknown model", "bad shape"])
def test_error_statuses_match_reference(servers, case):
    _, th = servers
    errors = []
    for mod in PACKAGES.values():
        with mod.InferenceServerClient(th.http_url) as client:
            if case == "unknown model":
                call = lambda: client.infer(  # noqa: E731
                    "no_such_model", _simple_inputs(mod, *_ab(9)))
            else:
                x = mod.InferInput("INPUT0", [2, 8], "INT32")
                x.set_data_from_numpy(np.zeros((2, 8), np.int32))
                y = mod.InferInput("INPUT1", [1, 16], "INT32")
                y.set_data_from_numpy(np.zeros((1, 16), np.int32))
                call = lambda: client.infer("simple", [x, y])  # noqa: E731
            with pytest.raises(Exception) as err:
                call()
            assert type(err.value).__name__ == "InferenceServerException"
            errors.append((err.value.status(), err.value.message()))
    assert errors[0] == errors[1]
    assert errors[0][0] == "400"


def test_connection_closed_by_the_server_is_reopened(servers, accepted,
                                                     monkeypatch):
    _, th = servers
    # the server drops a kept-alive connection idle for 0.2 s
    monkeypatch.setattr(ths._Handler, "timeout", 0.2)
    seen = []
    infer = th.core.infer

    def count(request):
        seen.append(request.id)
        return infer(request)

    monkeypatch.setattr(th.core, "infer", count)
    with thttp.InferenceServerClient(th.http_url) as client:
        a, b = _ab(10)
        ins = _simple_inputs(thttp, a, b)
        client.infer("simple", ins, request_id="first")
        deadline = time.monotonic() + 10
        while len(accepted) < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.6)  # the server has closed the idle connection
        res = client.infer("simple", ins, request_id="second")
        np.testing.assert_array_equal(res.as_numpy("OUTPUT0"), a + b)
    assert seen == ["first", "second"]  # each sent once
    assert len(accepted) == 2  # on a new connection


def test_no_server_raises():
    with thttp.InferenceServerClient(f"127.0.0.1:{free_port()}") as client:
        with pytest.raises(ConnectionRefusedError):
            client.is_server_live()


def test_parameters_without_their_machinery_raise():
    """TLS still raises with its ROADMAP item; the retry layer's and QoS's
    parameters are taken (the retry layer is ported) and the call goes on
    to the network, here to a port nothing listens on."""
    from triton_client_tpu_torch._resilience import RetryPolicy

    ins = _simple_inputs(thttp, *_ab(11))
    with pytest.raises(NotImplementedError, match="ROADMAP A3b"):
        thttp.InferenceServerClient("localhost:1", ssl=True)
    client = thttp.InferenceServerClient(
        f"127.0.0.1:{free_port()}", retry_policy=RetryPolicy(max_attempts=1))
    for kw in ({"retry_policy": RetryPolicy(max_attempts=1)},
               {"deadline_s": 5.0}, {"tenant": "t", "priority": 2}):
        with pytest.raises(ConnectionRefusedError):
            client.infer("simple", ins, **kw)
        with pytest.raises(InferenceServerException, match="refused"):
            client.async_infer("simple", ins, **kw).get_result(timeout=30)
    with pytest.raises(InferenceServerException, match="scheme"):
        thttp.InferenceServerClient("http://localhost:1")
