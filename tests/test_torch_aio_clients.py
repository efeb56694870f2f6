"""The port's asyncio clients (``http.aio``, ``grpc.aio``, ``cluster.aio``)
against the reference's, on the CPU.

The counterpart of ``tests/test_aio_clients.py`` and of
``tests/test_cluster.py``'s aio cases (:305, :405), case for case with the
same numpy inputs:

* within each package: the port's aio client against the port's server
  and the reference's aio client against the reference's server give
  equal answers (the reference's gRPC aio client on its HTTP/2 port);
* across packages, HTTP only: the port's aio client against the
  reference's server and the reference's against the port's;
* the slice as a whole: the tiny ``longctx_tpu`` preset in f32 with the
  flash gate at 64, served by both packages and read through both
  packages' aio clients, equal within 2e-4 (f32 forwards that sum in a
  different order; the transformer tests' f32 bound);
* the modules' public names equal the reference's;
* the edge cases of the port's own transport: a cancelled and a timed-out
  request close their connection and leave the pool sound, a stream
  cancels and times out cleanly, a hedge's loser is cancelled.
"""

import asyncio
import dataclasses
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import triton_client_tpu.grpc as jgrpc
import triton_client_tpu.http as jhttp
from triton_client_tpu.grpc import aio as jgrpc_aio
from triton_client_tpu.http import aio as jhttp_aio
from triton_client_tpu.models import language as jlang
from triton_client_tpu.models import transformer as jtr
from triton_client_tpu.models import zoo as jzoo
from triton_client_tpu.server.registry import ModelRegistry as JaxRegistry
from triton_client_tpu.server.testing import ServerHarness as JaxHarness
from triton_client_tpu.utils import InferenceServerException as JaxError
import triton_client_tpu_torch.grpc as tgrpc
import triton_client_tpu_torch.http as thttp
from triton_client_tpu_torch.cluster import HedgePolicy
from triton_client_tpu_torch.cluster.aio import ClusterClient as AioCluster
from triton_client_tpu_torch.grpc import aio as tgrpc_aio
from triton_client_tpu_torch.http import aio as thttp_aio
from triton_client_tpu_torch.models import language as tlang
from triton_client_tpu_torch.models import zoo as tzoo
from triton_client_tpu_torch.server.chaos import ChaosInjector
from triton_client_tpu_torch.server.model import PyModel, make_config
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import (ClusterHarness,
                                                    ServerHarness)
from triton_client_tpu_torch.utils import InferenceServerException

#: the f32 slice's bound (see the module docstring)
F32_ATOL = 2e-4


def _sleepy():
    """``sleepy``: Y = X, after sleeping X[0] milliseconds."""
    cfg = make_config("sleepy", [("X", "INT32", [1])], [("Y", "INT32", [1])])

    def fn(inputs, params):
        x = np.asarray(inputs["X"])
        time.sleep(int(x[0]) / 1e3)
        return {"Y": x.astype(np.int32)}

    return PyModel(cfg, fn)


@pytest.fixture(scope="module")
def servers():
    """(port harness, reference harness), each serving its zoo; the port's
    also ``sleepy``."""
    jreg = JaxRegistry()
    jzoo.register_all(jreg)
    treg = ModelRegistry()
    tzoo.register_all(treg, device="cpu")
    treg.register_model(_sleepy())
    with ServerHarness(treg) as th, JaxHarness(jreg) as jh:
        yield th, jh


def _run(coro):
    return asyncio.run(coro)


def _simple_inputs(mod):
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    b = np.ones((1, 16), dtype=np.int32)
    i0 = mod.InferInput("INPUT0", [1, 16], "INT32")
    i0.set_data_from_numpy(a)
    i1 = mod.InferInput("INPUT1", [1, 16], "INT32")
    i1.set_data_from_numpy(b)
    return a, b, [i0, i1]


def _pairs(servers):
    """(package, aio HTTP module, sync HTTP module, server) of each
    package's own client and server."""
    th, jh = servers
    return [("port", thttp_aio, thttp, th.http_url),
            ("ref", jhttp_aio, jhttp, jh.http_url)]


def _grpc_pairs(servers):
    th, jh = servers
    return [("port", tgrpc_aio, tgrpc, th.http_url),
            ("ref", jgrpc_aio, jgrpc, f"127.0.0.1:{jh.grpc_port}")]


def _error_of(e):
    return (e.status(), e.message())


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------

class TestHttpAio:
    def test_health_metadata_infer(self, servers):
        async def main(aio, mod, url):
            async with aio.InferenceServerClient(url) as c:
                out = [await c.is_server_live(), await c.is_server_ready(),
                       await c.is_model_ready("simple")]
                meta = await c.get_server_metadata()
                out.append(bool(meta["name"]))
                md = await c.get_model_metadata("simple")
                out.append((md["name"], md["inputs"], md["outputs"]))
                cfg = await c.get_model_config("simple")
                out.append((cfg["name"], cfg["input"], cfg["output"]))
                idx = await c.get_model_repository_index()
                out.append(any(m["name"] == "simple" for m in idx))
                stats = await c.get_inference_statistics("simple")
                out.append("model_stats" in stats)
                a, b, inputs = _simple_inputs(mod)
                result = await c.infer("simple", inputs)
                np.testing.assert_array_equal(result.as_numpy("OUTPUT0"),
                                              a + b)
                np.testing.assert_array_equal(result.as_numpy("OUTPUT1"),
                                              a - b)
                out.append(result.as_numpy("OUTPUT0").tolist())
                return out

        got = {pkg: _run(main(aio, mod, url))
               for pkg, aio, mod, url in _pairs(servers)}
        assert got["port"] == got["ref"]

    def test_compression(self, servers):
        async def main(aio, mod, url):
            async with aio.InferenceServerClient(url) as c:
                a, b, inputs = _simple_inputs(mod)
                out = []
                for req, resp in (("gzip", "gzip"), ("deflate", "deflate"),
                                  (None, "gzip")):
                    result = await c.infer(
                        "simple", inputs,
                        request_compression_algorithm=req,
                        response_compression_algorithm=resp)
                    np.testing.assert_array_equal(
                        result.as_numpy("OUTPUT0"), a + b)
                    out.append(result.as_numpy("OUTPUT1").tolist())
                return out

        got = {pkg: _run(main(aio, mod, url))
               for pkg, aio, mod, url in _pairs(servers)}
        assert got["port"] == got["ref"]

    def test_error_surface(self, servers):
        async def main(aio, url, error):
            async with aio.InferenceServerClient(url) as c:
                with pytest.raises(error) as e:
                    await c.get_model_metadata("nope")
                return _error_of(e.value)

        th, jh = servers
        assert _run(main(thttp_aio, th.http_url, InferenceServerException)) \
            == _run(main(jhttp_aio, jh.http_url, JaxError))

    def test_forbidden_header_rejected(self, servers):
        async def main(aio, mod, url, error):
            async with aio.InferenceServerClient(url) as c:
                _a, _b, inputs = _simple_inputs(mod)
                with pytest.raises(error, match="Transfer-Encoding") as e:
                    await c.infer("simple", inputs,
                                  headers={"Transfer-Encoding": "chunked"})
                return e.value.message()

        th, jh = servers
        assert _run(main(thttp_aio, thttp, th.http_url,
                         InferenceServerException)) == \
            _run(main(jhttp_aio, jhttp, jh.http_url, JaxError))

    def test_request_body_statics_roundtrip(self, servers):
        """generate_request_body / parse_response_body: a body built
        offline by the port's aio statics, posted raw to each server, its
        stored answer parsed offline by each package's statics."""
        import urllib.request

        a, b, inputs = _simple_inputs(thttp)
        body, json_size = \
            thttp_aio.InferenceServerClient.generate_request_body(inputs)
        jbody, jsize = jhttp_aio.InferenceServerClient.generate_request_body(
            _simple_inputs(jhttp)[2])
        assert (body, json_size) == (jbody, jsize)
        outs = []
        for url, aio in ((servers[0].http_url, thttp_aio),
                         (servers[1].http_url, jhttp_aio)):
            req = urllib.request.Request(
                f"http://{url}/v2/models/simple/infer", data=body,
                headers={"Inference-Header-Content-Length": str(json_size)})
            with urllib.request.urlopen(req, timeout=30) as r:
                header_len = r.headers.get("Inference-Header-Content-Length")
                raw = r.read()
            result = aio.InferenceServerClient.parse_response_body(
                raw, header_length=int(header_len) if header_len else None)
            np.testing.assert_array_equal(result.as_numpy("OUTPUT0"), a + b)
            np.testing.assert_array_equal(result.as_numpy("OUTPUT1"), a - b)
            outs.append(result.get_response())
        assert outs[0] == outs[1]

    def test_method_surface_matches_sync(self):
        """The port's aio client has its sync client's public surface, less
        the sync client's future-based ``async_infer``, as in the
        reference."""
        sync_only = {
            n for n in dir(thttp.InferenceServerClient)
            if not n.startswith("_")} - {
            n for n in dir(thttp_aio.InferenceServerClient)
            if not n.startswith("_")}
        assert sync_only <= {"async_infer"}, sync_only

    def test_across_packages(self, servers):
        """The port's aio client against the reference's server and the
        reference's aio client against the port's: the answers, the
        gzipped one included, of each package's own pair."""
        th, jh = servers

        async def main(aio, mod, url):
            async with aio.InferenceServerClient(url) as c:
                _a, _b, inputs = _simple_inputs(mod)
                plain = await c.infer("simple", inputs)
                gz = await c.infer("simple", inputs,
                                   response_compression_algorithm="gzip")
                md = await c.get_model_metadata("simple")
                return (plain.as_numpy("OUTPUT0").tolist(),
                        gz.as_numpy("OUTPUT1").tolist(), md["inputs"])

        own = _run(main(thttp_aio, thttp, th.http_url))
        assert _run(main(thttp_aio, thttp, jh.http_url)) == own
        assert _run(main(jhttp_aio, jhttp, th.http_url)) == own


# ---------------------------------------------------------------------------
# gRPC
# ---------------------------------------------------------------------------

class TestGrpcAio:
    def test_health_metadata_infer(self, servers):
        async def main(aio, mod, url):
            async with aio.InferenceServerClient(url) as c:
                out = [await c.is_server_live(), await c.is_server_ready(),
                       await c.is_model_ready("simple")]
                meta = await c.get_server_metadata()
                out.append(bool(meta.name))
                md = await c.get_model_metadata("simple", as_json=True)
                out.append((md["name"], md["inputs"], md["outputs"]))
                a, b, inputs = _simple_inputs(mod)
                result = await c.infer("simple", inputs)
                np.testing.assert_array_equal(result.as_numpy("OUTPUT0"),
                                              a + b)
                np.testing.assert_array_equal(result.as_numpy("OUTPUT1"),
                                              a - b)
                out.append(result.as_numpy("OUTPUT1").tolist())
                return out

        got = {pkg: _run(main(aio, mod, url))
               for pkg, aio, mod, url in _grpc_pairs(servers)}
        assert got["port"] == got["ref"]

    def test_stream_infer_sequences(self, servers):
        """Two interleaved sequences over one stream (the aio analog of
        simple_grpc_aio_sequence_stream_infer_client.py)."""
        values = [11, 7, 5]

        async def main(aio, mod, url):
            async with aio.InferenceServerClient(url) as c:
                async def requests():
                    for seq_id in (1001, 1002):
                        for i, v in enumerate(values):
                            arr = np.array([v if seq_id == 1001 else -v],
                                           dtype=np.int32)
                            inp = mod.InferInput("INPUT", [1], "INT32")
                            inp.set_data_from_numpy(arr)
                            yield {"model_name": "simple_sequence",
                                   "inputs": [inp], "sequence_id": seq_id,
                                   "sequence_start": i == 0,
                                   "sequence_end": i == len(values) - 1}

                results = []
                async for result, error in c.stream_infer(requests()):
                    assert error is None, error
                    results.append(int(result.as_numpy("OUTPUT")[0]))
                return results

        got = {pkg: _run(main(aio, mod, url))
               for pkg, aio, mod, url in _grpc_pairs(servers)}
        acc = np.cumsum(values)
        assert got["port"] == got["ref"] == list(acc) + list(-acc)

    def test_stream_infer_decoupled(self, servers):
        """The decoupled ``repeat_int32`` over the aio stream, its empty
        final response asked for."""
        async def main(aio, mod, url):
            async with aio.InferenceServerClient(url) as c:
                async def requests():
                    i_in = mod.InferInput("IN", [4], "INT32")
                    i_in.set_data_from_numpy(np.array([4, 2, 0, 1], np.int32))
                    i_d = mod.InferInput("DELAY", [4], "UINT32")
                    i_d.set_data_from_numpy(np.zeros(4, np.uint32))
                    i_w = mod.InferInput("WAIT", [1], "UINT32")
                    i_w.set_data_from_numpy(np.array([0], np.uint32))
                    yield {"model_name": "repeat_int32",
                           "inputs": [i_in, i_d, i_w],
                           "enable_empty_final_response": True}

                outs, finals = [], 0
                async for result, error in c.stream_infer(requests()):
                    assert error is None, error
                    params = result.get_response().parameters
                    if params["triton_final_response"].bool_param:
                        finals += 1
                        break
                    outs.append(int(result.as_numpy("OUT")[0]))
                return outs, finals

        got = {pkg: _run(main(aio, mod, url))
               for pkg, aio, mod, url in _grpc_pairs(servers)}
        assert got["port"] == got["ref"] == ([4, 2, 0, 1], 1)

    def test_error_surface(self, servers):
        async def main(aio, url, error):
            async with aio.InferenceServerClient(url) as c:
                with pytest.raises(error) as e:
                    await c.get_model_metadata("nope")
                return _error_of(e.value)

        th, jh = servers
        assert _run(main(tgrpc_aio, th.http_url,
                         InferenceServerException)) == \
            _run(main(jgrpc_aio, f"127.0.0.1:{jh.grpc_port}", JaxError))

    def test_compression_and_infer_many(self, servers):
        """``compression_algorithm`` gzip and deflate (request frames
        compressed, answers plain) and ``infer_many``, against the
        reference's HTTP/2 client with the same arguments."""
        async def main(aio, mod, url):
            async with aio.InferenceServerClient(url) as c:
                _a, _b, inputs = _simple_inputs(mod)
                out = [(await c.infer("simple", inputs,
                                      compression_algorithm=alg)
                        ).as_numpy("OUTPUT0").tolist()
                       for alg in (None, "gzip", "deflate")]
                many = await c.infer_many("simple", [inputs] * 3, window=2)
                out.append([r.as_numpy("OUTPUT1").tolist() for r in many])
                return out

        got = {pkg: _run(main(aio, mod, url))
               for pkg, aio, mod, url in _grpc_pairs(servers)}
        assert got["port"] == got["ref"]


# ---------------------------------------------------------------------------
# the surface
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("port_mod,ref_mod", [
    ("triton_client_tpu_torch.http.aio", "triton_client_tpu.http.aio"),
    ("triton_client_tpu_torch.grpc.aio", "triton_client_tpu.grpc.aio"),
    ("triton_client_tpu_torch.cluster.aio", "triton_client_tpu.cluster.aio"),
    ("triton_client_tpu_torch.http.aio.auth",
     "triton_client_tpu.http.aio.auth"),
    ("triton_client_tpu_torch.grpc.aio.auth",
     "triton_client_tpu.grpc.aio.auth"),
    ("triton_client_tpu_torch.http.auth", "triton_client_tpu.http.auth"),
    ("triton_client_tpu_torch.grpc.auth", "triton_client_tpu.grpc.auth"),
    ("triton_client_tpu_torch._uvloop", "triton_client_tpu._uvloop"),
])
def test_public_names_equal_the_reference(port_mod, ref_mod):
    """Each aio module's ``__all__`` and every exported class's public
    names and signatures are the reference's."""
    import importlib
    import inspect

    tm, jm = importlib.import_module(port_mod), importlib.import_module(
        ref_mod)
    assert sorted(tm.__all__) == sorted(jm.__all__)
    for name in tm.__all__:
        t, j = getattr(tm, name), getattr(jm, name)
        if not inspect.isclass(t):
            assert inspect.signature(t) == inspect.signature(j), name
            continue
        t_names = {n for n in dir(t) if not n.startswith("_")}
        j_names = {n for n in dir(j) if not n.startswith("_")}
        assert t_names == j_names, (name, t_names ^ j_names)
        for n in sorted(t_names | {"__init__"}):
            tf, jf = getattr(t, n), getattr(j, n)
            if callable(tf) and not inspect.isclass(tf):
                tp = list(inspect.signature(tf).parameters.items())
                jp = list(inspect.signature(jf).parameters.items())
                assert [(k, p.default) for k, p in tp] == \
                    [(k, p.default) for k, p in jp], (name, n)
                assert inspect.iscoroutinefunction(tf) == \
                    inspect.iscoroutinefunction(jf), (name, n)


def test_uvloop_opt_in_returns_false_without_uvloop(monkeypatch):
    """uvloop is installed on neither machine: the opt-in is a no-op that
    returns False, in both packages."""
    from triton_client_tpu import _uvloop as juv
    from triton_client_tpu_torch import _uvloop as tuv

    monkeypatch.setenv("TRITON_TPU_UVLOOP", "1")
    assert tuv.maybe_install_uvloop() == juv.maybe_install_uvloop()
    assert tuv.uvloop_active() == juv.uvloop_active()
    monkeypatch.delenv("TRITON_TPU_UVLOOP")
    assert tuv.maybe_install_uvloop() is False


# ---------------------------------------------------------------------------
# the slice as a whole: longctx_tpu tiny in f32, flash gate at 64
# ---------------------------------------------------------------------------

def test_longctx_f32_through_both_packages_aio_clients(monkeypatch):
    """Both packages serve the tiny ``longctx_tpu`` in f32 from the same
    seeded weights, the attention past the flash gate (S = 512 > 64);
    each package's aio HTTP and gRPC clients read both servers, and every
    answer agrees within F32_ATOL."""
    import jax

    monkeypatch.setenv("TRITON_TPU_FLASH_MIN_S", "64")
    jcfg, S = jlang._LONGCTX_PRESETS["tiny"]
    monkeypatch.setitem(jlang._LONGCTX_PRESETS, "tiny",
                        (dataclasses.replace(jcfg, dtype=jnp.float32), S))
    tcfg, tS = tlang._LONGCTX_PRESETS["tiny"]
    monkeypatch.setitem(tlang._LONGCTX_PRESETS, "tiny",
                        (dataclasses.replace(tcfg, dtype=torch.float32), tS))
    params = {k: np.asarray(v) for k, v in jtr.init_params(
        jax.random.PRNGKey(11), jlang.longctx_cfg()).items()}
    jreg = JaxRegistry()
    jreg.register_model(jlang.make_longctx_tpu())
    treg = ModelRegistry()
    treg.register_model(tlang.make_longctx_tpu("cpu", params=params))
    tokens = np.random.default_rng(3).integers(0, 256, (2, S)).astype(
        np.int32)

    async def read(aio, mod, url):
        async with aio.InferenceServerClient(url) as c:
            x = mod.InferInput("TOKENS", [2, S], "INT32")
            x.set_data_from_numpy(tokens)
            return (await c.infer("longctx_tpu", [x])).as_numpy("LOGPROBS")

    with ServerHarness(treg) as th, JaxHarness(jreg) as jh:
        answers = {
            "port http.aio, port": _run(read(thttp_aio, thttp, th.http_url)),
            "port grpc.aio, port": _run(read(tgrpc_aio, tgrpc, th.http_url)),
            "ref http.aio, ref": _run(read(jhttp_aio, jhttp, jh.http_url)),
            "ref grpc.aio, ref": _run(read(
                jgrpc_aio, jgrpc, f"127.0.0.1:{jh.grpc_port}")),
            "port http.aio, ref": _run(read(thttp_aio, thttp, jh.http_url)),
            "ref http.aio, port": _run(read(jhttp_aio, jhttp, th.http_url)),
        }
    want = answers["ref http.aio, ref"]
    assert want.shape == (2, S) and want.dtype == np.float32
    assert np.isfinite(want).all() and (want[:, -1] == 0).all()
    for name, got in answers.items():
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the port's transport: cancellation, timeouts, streams
# ---------------------------------------------------------------------------

def _sleepy_input(mod, ms: int):
    x = mod.InferInput("X", [1], "INT32")
    x.set_data_from_numpy(np.array([ms], np.int32))
    return [x]


def test_cancelled_request_does_not_poison_the_pool(servers):
    """A request cancelled in flight closes its connection: the pool keeps
    nothing half-read, and the next request on the same client (one
    connection at most) gets its own answer."""
    th, _ = servers

    async def main():
        async with thttp_aio.InferenceServerClient(th.http_url,
                                                   conn_limit=1) as c:
            await c.infer("sleepy", _sleepy_input(thttp, 1))
            assert len(c._pool._idle) == 1
            task = asyncio.ensure_future(
                c.infer("sleepy", _sleepy_input(thttp, 400)))
            await asyncio.sleep(0.1)
            task.cancel()
            with pytest.raises(asyncio.CancelledError):
                await task
            assert len(c._pool._idle) == 0
            _a, _b, inputs = _simple_inputs(thttp)
            r = await c.infer("simple", inputs)
            r2 = await c.infer("sleepy", _sleepy_input(thttp, 7))
            return r.as_numpy("OUTPUT0").tolist(), r2.as_numpy("Y").tolist()

    simple, sleepy = _run(main())
    assert simple == [list(range(1, 17))] and sleepy == [7]


def test_timed_out_request_does_not_poison_the_pool(servers):
    """``conn_timeout`` is a request's total: past it TimeoutError, the
    connection closed; the late answer never reaches the next request."""
    th, _ = servers

    async def main():
        async with thttp_aio.InferenceServerClient(
                th.http_url, conn_limit=1, conn_timeout=0.2) as c:
            t0 = time.monotonic()
            with pytest.raises(TimeoutError):
                await c.infer("sleepy", _sleepy_input(thttp, 3000))
            took = time.monotonic() - t0
            assert len(c._pool._idle) == 0
            r = await c.infer("sleepy", _sleepy_input(thttp, 3))
            return took, r.as_numpy("Y").tolist()

    took, got = _run(main())
    assert took < 2.0 and got == [3]


def test_grpc_deadline_is_deadline_exceeded_and_pool_stays_sound(servers):
    th, _ = servers

    async def main():
        async with tgrpc_aio.InferenceServerClient(th.http_url) as c:
            with pytest.raises(InferenceServerException) as e:
                await c.infer("sleepy", _sleepy_input(tgrpc, 3000),
                              client_timeout=0.2)
            r = await c.infer("sleepy", _sleepy_input(tgrpc, 5))
            return e.value.status(), r.as_numpy("Y").tolist()

    assert _run(main()) == ("StatusCode.DEADLINE_EXCEEDED", [5])


def test_stale_kept_alive_connection_is_sent_again(servers):
    """The server closes a kept-alive connection while it sits idle: the
    next request goes out again on a new connection, counted."""
    treg = ModelRegistry()
    treg.register_model(tzoo.make_simple())

    async def main(h):
        async with thttp_aio.InferenceServerClient(h.http_url) as c:
            _a, _b, inputs = _simple_inputs(thttp)
            await c.infer("simple", inputs)
            h._server.close_connections()
            await asyncio.sleep(0.05)
            r = await c.infer("simple", inputs)
            return c._pool.resends, r.as_numpy("OUTPUT0").tolist()

    with ServerHarness(treg) as h:
        resends, got = _run(main(h))
    assert resends == 1 and got == [list(range(1, 17))]


def test_stream_cancels_cleanly(servers):
    """``cancel()`` mid-stream ends the iteration, closes the stream's
    connection and leaves the client usable."""
    th, _ = servers

    async def main():
        async with tgrpc_aio.InferenceServerClient(th.http_url) as c:
            async def requests():
                for _ in range(3):
                    yield {"model_name": "sleepy",
                           "inputs": _sleepy_input(tgrpc, 1000)}

            it = c.stream_infer(requests())
            got = []

            async def consume():
                async for result, error in it:
                    got.append((result, error))

            task = asyncio.ensure_future(consume())
            await asyncio.sleep(0.1)
            t0 = time.monotonic()
            assert it.cancel()
            await asyncio.wait_for(task, 5)
            took = time.monotonic() - t0
            assert c._streams == set()
            r = await c.infer("sleepy", _sleepy_input(tgrpc, 2))
            return len(got), took, r.as_numpy("Y").tolist()

    n, took, after = _run(main())
    assert n == 0 and took < 2.0 and after == [2]


def test_stream_timeout_ends_the_stream(servers):
    """``stream_timeout`` bounds the whole stream: past it the iteration
    ends (a failure of the call, as a grpc.aio RpcError ends the
    reference's), with the answers that came before it."""
    th, _ = servers

    async def main():
        async with tgrpc_aio.InferenceServerClient(th.http_url) as c:
            async def requests():
                for ms in (10, 4000):
                    yield {"model_name": "sleepy",
                           "inputs": _sleepy_input(tgrpc, ms)}

            t0 = time.monotonic()
            got = [r.as_numpy("Y").tolist()
                   async for r, e in c.stream_infer(requests(),
                                                    stream_timeout=0.4)]
            return got, time.monotonic() - t0

    got, took = _run(main())
    assert got == [[10]] and took < 3.0


def test_stream_raises_an_invalid_request_dict(servers):
    th, _ = servers

    async def main():
        async with tgrpc_aio.InferenceServerClient(th.http_url) as c:
            async def requests():
                yield {"inputs": []}

            with pytest.raises(InferenceServerException,
                               match="model_name and/or inputs"):
                async for _ in c.stream_infer(requests()):
                    pass

    _run(main())


# ---------------------------------------------------------------------------
# cluster.aio (tests/test_cluster.py:305 and :405)
# ---------------------------------------------------------------------------

def _identity_registry():
    r = ModelRegistry()
    r.register_model(tzoo.make_custom_identity_int32())
    return r


@pytest.fixture(scope="module")
def cluster():
    with ClusterHarness(_identity_registry, n=3) as ch:
        yield ch


def _x(n=4):
    return np.arange(n, dtype=np.int32).reshape(1, n)


def _identity_inputs(mod, x):
    i = mod.InferInput("INPUT0", list(x.shape), "INT32")
    i.set_data_from_numpy(x)
    return [i]


def test_aio_lazy_client_after_close_raises_not_leaks():
    """A task resuming after ``close()`` gets the typed error, not a fresh
    client leaked into an already-snapshotted dict, in both packages."""
    from triton_client_tpu.cluster.aio import ClusterClient as JaxAio

    async def scenario(cls, error):
        c = cls(["a:1", "b:1"], protocol="http")
        await c.close()
        ep = c.pool.endpoint("a:1")
        with pytest.raises(error, match="closed") as e:
            c._client_for(ep)
        assert c._clients == {}
        return e.value.message()

    assert _run(scenario(AioCluster, InferenceServerException)) == \
        _run(scenario(JaxAio, JaxError))


@pytest.mark.parametrize("protocol", ["http", "grpc"])
def test_aio_cluster_round_trip(cluster, protocol):
    """Round robin over three replicas: every replica routed to, every
    answer the input."""
    mod = thttp if protocol == "http" else tgrpc

    async def main():
        routes = []
        async with AioCluster(
                cluster.http_urls, protocol=protocol, policy="round_robin",
                on_route=lambda u, m, s: routes.append(u)) as c:
            assert await c.is_server_ready() is True
            x = _x()
            for _ in range(3):
                r = await c.infer("custom_identity_int32",
                                  _identity_inputs(mod, x))
                np.testing.assert_array_equal(r.as_numpy("OUTPUT0"), x)
        return routes

    assert set(_run(main())) == set(cluster.http_urls)


def test_aio_hedge_cancels_the_loser(cluster):
    """Replica 0 answers 3 s late; hedged at 50 ms, the backup wins,
    the primary's task is cancelled: its endpoint holds nothing
    outstanding and its client's pool no half-read connection."""
    from triton_client_tpu_torch._telemetry import telemetry

    urls = cluster.http_urls
    cluster.chaos(0, ChaosInjector(rate=1.0, kinds=["latency"],
                                   latency_ms=3000.0, seed=3))

    def wins():
        return sum(h["wins"] for h in telemetry().snapshot()["hedges"])

    async def main():
        async with AioCluster(urls[:2], protocol="http",
                              policy="round_robin",
                              hedge=HedgePolicy(default_delay_s=0.05,
                                                min_samples=1 << 30)) as c:
            x = _x()
            w0 = wins()
            t0 = time.monotonic()
            r = await c.infer("custom_identity_int32",
                              _identity_inputs(thttp, x), hedge=True)
            took = time.monotonic() - t0
            np.testing.assert_array_equal(r.as_numpy("OUTPUT0"), x)
            slow = c.pool.endpoint(urls[0])
            return (took, wins() - w0, slow.outstanding,
                    len(c._clients[urls[0]]._pool._idle))

    try:
        took, won, outstanding, idle = _run(main())
    finally:
        cluster.chaos(0, None)
    assert took < 2.0 and won == 1
    assert outstanding == 0 and idle == 0
