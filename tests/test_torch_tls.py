"""TLS in the port, both sides, against the reference's, on the CPU.

The counterpart of ``tests/test_tls.py``, case for case: each package's
server serves HTTPS (the port's gRPC-Web over it; the reference's secure
HTTP/2 gRPC) from a certificate its own ``generate_self_signed`` made,
and each package's four clients (HTTP and gRPC, sync and aio) connect with
the CA pinned; a plain client against the TLS port and a client that does
not trust the CA fail as the reference's do.  ``creds`` is an
``ssl.SSLContext`` in the port (no ``grpc.ChannelCredentials`` exists on
the card's machine).  Beyond the reference's cases: the committed test
pair (``tests/data/torch_tls``) verifies as the generated one does and
refuses a client of the other CA; a silent connection does not hold the
accept loop (the handshake runs in the connection's thread); the metrics
port serves TLS; a CLI fleet of ``--frontends 2`` serves TLS on every
worker; the CLI's flag errors are the reference's word for word; a pair
that does not load fails the server's start; ``generate_self_signed``
falls back to the ``openssl`` command.
"""

import asyncio
import os
import re
import socket
import ssl as ssl_mod
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

import triton_client_tpu.grpc as jgrpc
import triton_client_tpu.grpc.aio as jgrpc_aio
import triton_client_tpu.http as jhttp
import triton_client_tpu.http.aio as jhttp_aio
from triton_client_tpu.models import zoo as jzoo
from triton_client_tpu.server import tls as jtls
from triton_client_tpu.server.registry import ModelRegistry as JaxRegistry
from triton_client_tpu.server.testing import ServerHarness as JaxHarness
from triton_client_tpu.utils import InferenceServerException as JaxError
import triton_client_tpu_torch.grpc as tgrpc
import triton_client_tpu_torch.grpc.aio as tgrpc_aio
import triton_client_tpu_torch.http as thttp
import triton_client_tpu_torch.http.aio as thttp_aio
from triton_client_tpu_torch.models import zoo as tzoo
from triton_client_tpu_torch.server import tls as ttls
from triton_client_tpu_torch.server.core import InferenceCore
from triton_client_tpu_torch.server.http_server import (HttpServer,
                                                        MetricsServer)
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import ServerHarness
from triton_client_tpu_torch.utils import InferenceServerException

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = ttls.TLSConfig(
    os.path.join(REPO, "tests", "data", "torch_tls", "server.crt"),
    os.path.join(REPO, "tests", "data", "torch_tls", "server.key"))


@pytest.fixture(scope="module")
def material(tmp_path_factory):
    """Each package's own generated pair: port, reference."""
    return (ttls.generate_self_signed(str(tmp_path_factory.mktemp("t"))),
            jtls.generate_self_signed(str(tmp_path_factory.mktemp("j"))))


@pytest.fixture(scope="module")
def servers(material):
    """The port's and the reference's TLS servers of their zoos, on
    ``localhost``: (port harness, reference harness)."""
    treg = ModelRegistry()
    tzoo.register_all(treg, device="cpu")
    jreg = JaxRegistry()
    jzoo.register_all(jreg)
    with ServerHarness(treg, host="localhost", tls=material[0]) as th, \
            JaxHarness(jreg, host="localhost", tls=material[1]) as jh:
        yield th, jh


def _inputs():
    rng = np.random.default_rng(7)
    a = rng.integers(0, 100, (1, 16), dtype=np.int32)
    b = rng.integers(0, 100, (1, 16), dtype=np.int32)
    return a, b


def _simple(mod):
    a, b = _inputs()
    in0 = mod.InferInput("INPUT0", a.shape, "INT32")
    in0.set_data_from_numpy(a)
    in1 = mod.InferInput("INPUT1", b.shape, "INT32")
    in1.set_data_from_numpy(b)
    return [in0, in1]


def _check(result):
    a, b = _inputs()
    np.testing.assert_array_equal(result.as_numpy("OUTPUT0"), a + b)
    np.testing.assert_array_equal(result.as_numpy("OUTPUT1"), a - b)
    return result.as_numpy("OUTPUT0").tolist()


def _packages(servers, material):
    """(name, http, http.aio, grpc, grpc.aio, its server's HTTP URL, gRPC
    URL, its CA file) of each package."""
    th, jh = servers
    return [("port", thttp, thttp_aio, tgrpc, tgrpc_aio, th.http_url,
             th.grpc_url, material[0].certfile),
            ("ref", jhttp, jhttp_aio, jgrpc, jgrpc_aio, jh.http_url,
             jh.grpc_url, material[1].certfile)]


# ---------------------------------------------------------------------------
# the reference's cases
# ---------------------------------------------------------------------------

class TestHttpsSync:
    def test_https_infer_with_ca(self, servers, material):
        got = {}
        for name, http, _, _, _, url, _, ca in _packages(servers, material):
            with http.InferenceServerClient(
                    url, ssl=True, ssl_options={"ca_certs": ca}) as client:
                assert client.is_server_live()
                got[name] = _check(client.infer("simple", _simple(http)))
        assert got["port"] == got["ref"]

    def test_https_rejects_untrusted_ca(self, servers, material):
        for _, http, _, _, _, url, _, _ in _packages(servers, material):
            with http.InferenceServerClient(
                    url, ssl=True,
                    ssl_options={"cert_reqs": ssl_mod.CERT_REQUIRED}) \
                    as client:
                with pytest.raises(Exception) as exc_info:
                    client.is_server_live()
                assert "certificate" in str(exc_info.value).lower()

    def test_plain_http_client_fails_against_tls_port(self, servers,
                                                       material):
        for _, http, _, _, _, url, _, _ in _packages(servers, material):
            with http.InferenceServerClient(url) as client:
                with pytest.raises(Exception):
                    client.get_server_metadata()


class TestHttpsAio:
    def test_https_aio_infer(self, servers, material):
        async def main(http, aio, url, ca):
            ctx = ssl_mod.create_default_context(cafile=ca)
            async with aio.InferenceServerClient(url, ssl=True,
                                                 ssl_context=ctx) as client:
                assert await client.is_server_live()
                return _check(await client.infer("simple", _simple(http)))

        got = {name: asyncio.run(main(http, aio, url, ca))
               for name, http, aio, _, _, url, _, ca
               in _packages(servers, material)}
        assert got["port"] == got["ref"]


class TestSecureGrpc:
    def test_grpcs_infer_with_root_cert(self, servers, material):
        got = {}
        for name, _, _, grpc, _, _, url, ca in _packages(servers, material):
            with grpc.InferenceServerClient(
                    url, ssl=True, root_certificates=ca) as client:
                assert client.is_server_live()
                got[name] = _check(client.infer("simple", _simple(grpc)))
        assert got["port"] == got["ref"]

    def test_grpcs_with_creds_object(self, servers, material):
        """The reference takes ``grpc.ChannelCredentials``; the port, which
        has no grpcio on the card's machine, an ``ssl.SSLContext``."""
        import grpc

        th, jh = servers
        with open(material[1].certfile, "rb") as f:
            creds = grpc.ssl_channel_credentials(root_certificates=f.read())
        with jgrpc.InferenceServerClient(jh.grpc_url, creds=creds) as c:
            ref = c.is_server_ready()
        ctx = ssl_mod.create_default_context(cafile=material[0].certfile)
        with tgrpc.InferenceServerClient(th.grpc_url, creds=ctx) as c:
            assert c.is_server_ready() == ref is True
        with pytest.raises(InferenceServerException, match="SSLContext"):
            tgrpc.InferenceServerClient(th.grpc_url, creds=creds)

    def test_insecure_channel_fails_against_tls_port(self, servers,
                                                      material):
        errors = []
        for _, _, _, grpc, _, _, url, _ in _packages(servers, material):
            with grpc.InferenceServerClient(url) as client:
                with pytest.raises((InferenceServerException,
                                    JaxError)) as e:
                    client.is_server_live(client_timeout=5)
                errors.append(e.value.status())
        assert errors == ["StatusCode.UNAVAILABLE"] * 2

    def test_grpcs_aio_infer(self, servers, material):
        async def main(grpc, aio, url, ca):
            async with aio.InferenceServerClient(
                    url, ssl=True, root_certificates=ca) as client:
                assert await client.is_server_live()
                return _check(await client.infer("simple", _simple(grpc)))

        got = {name: asyncio.run(main(grpc, aio, url, ca))
               for name, _, _, grpc, aio, _, url, ca
               in _packages(servers, material)}
        assert got["port"] == got["ref"]


# ---------------------------------------------------------------------------
# the port's own: the committed pair, the accept loop, the metrics port, the
# CLI, the errors
# ---------------------------------------------------------------------------

def test_committed_pair_verifies_as_the_generated_one(servers, material):
    """The committed pair serves and verifies as a generated pair does;
    each CA refuses the other's server; both certificates name
    ``localhost`` and ``127.0.0.1``."""
    treg = ModelRegistry()
    treg.register_model(tzoo.make_simple())
    with ServerHarness(treg, host="127.0.0.1", tls=COMMITTED) as h:
        with thttp.InferenceServerClient(
                h.http_url, ssl=True,
                ssl_options={"ca_certs": COMMITTED.certfile}) as c:
            committed = _check(c.infer("simple", _simple(thttp)))
        with thttp.InferenceServerClient(
                h.http_url, ssl=True,
                ssl_options={"ca_certs": material[0].certfile}) as c:
            with pytest.raises(ssl_mod.SSLCertVerificationError):
                c.is_server_live()
    with thttp.InferenceServerClient(
            servers[0].http_url, ssl=True,
            ssl_options={"ca_certs": COMMITTED.certfile}) as c:
        with pytest.raises(ssl_mod.SSLCertVerificationError):
            c.is_server_live()
    with thttp.InferenceServerClient(
            servers[0].http_url, ssl=True,
            ssl_options={"ca_certs": material[0].certfile}) as c:
        assert _check(c.infer("simple", _simple(thttp))) == committed
    for cfg in (COMMITTED, material[0]):
        cert = ssl_mod._ssl._test_decode_cert(cfg.certfile)
        assert {("DNS", "localhost"), ("IP Address", "127.0.0.1")} <= set(
            cert["subjectAltName"])


def test_handshake_runs_off_the_accept_loop():
    """A client that connects and says nothing holds only its own
    connection's thread: another client's HTTPS request is answered at
    once, and the silent one is dropped after the handshake's timeout."""
    treg = ModelRegistry()
    treg.register_model(tzoo.make_simple())
    with ServerHarness(treg, tls=COMMITTED) as h:
        silent = [socket.create_connection(("127.0.0.1", h.http_port))
                  for _ in range(3)]
        try:
            t0 = time.monotonic()
            with thttp.InferenceServerClient(
                    h.http_url, ssl=True,
                    ssl_options={"ca_certs": COMMITTED.certfile}) as c:
                _check(c.infer("simple", _simple(thttp)))
            assert time.monotonic() - t0 < 2.0
        finally:
            for s in silent:
                s.close()


def test_no_h2_is_offered_and_the_h2c_preface_is_refused_inside_tls():
    """ALPN offers HTTP/1.1 only; an HTTP/2 preface sent inside the TLS
    stream gets C4's HTTP/1.1 400."""
    treg = ModelRegistry()
    treg.register_model(tzoo.make_simple())
    ctx = ssl_mod.create_default_context(cafile=COMMITTED.certfile)
    ctx.set_alpn_protocols(["h2", "http/1.1"])
    with ServerHarness(treg, tls=COMMITTED) as h, socket.create_connection(
            ("127.0.0.1", h.http_port)) as raw, \
            ctx.wrap_socket(raw, server_hostname="127.0.0.1") as s:
        assert s.selected_alpn_protocol() == "http/1.1"
        s.sendall(b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n")
        head = s.recv(4096)
    assert head.startswith(b"HTTP/1.1 400")


def test_metrics_port_serves_tls():
    """The ``--metrics-port`` listener serves HTTPS from the same pair, as
    the reference's does."""
    import threading

    core = InferenceCore(ModelRegistry())
    srv = MetricsServer(core, "127.0.0.1", 0, tls=COMMITTED)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        ctx = ssl_mod.create_default_context(cafile=COMMITTED.certfile)
        url = f"https://127.0.0.1:{srv.server_address[1]}/metrics"
        with urllib.request.urlopen(url, context=ctx, timeout=30) as r:
            assert r.status == 200 and b"nv_" in r.read()
        with pytest.raises(OSError):
            urllib.request.urlopen(
                f"http://127.0.0.1:{srv.server_address[1]}/metrics",
                timeout=30)
    finally:
        srv.shutdown()
        srv.server_close()
        core.shutdown()


def test_a_pair_that_does_not_load_fails_at_start(tmp_path):
    """A certificate that does not parse fails the listener's construction
    with the reference's error (its ``ssl_context()``)."""
    bad = tmp_path / "bad.crt"
    bad.write_text("not a certificate\n")
    ours = ttls.TLSConfig(str(bad), COMMITTED.keyfile)
    theirs = jtls.TLSConfig(str(bad), COMMITTED.keyfile)
    with pytest.raises(ssl_mod.SSLError) as t:
        HttpServer(InferenceCore(ModelRegistry()), "127.0.0.1", 0, tls=ours)
    with pytest.raises(ssl_mod.SSLError) as j:
        theirs.ssl_context()
    assert type(t.value) is type(j.value) and t.value.args == j.value.args


@pytest.mark.parametrize("certfile,keyfile", [
    ("cert.pem", None), (None, "key.pem"), ("missing.crt", "missing.key"),
    (None, None)])
def test_maybe_tls_errors_are_the_reference_s(tmp_path, certfile, keyfile):
    def outcome(fn):
        try:
            cfg = fn(certfile and str(tmp_path / certfile),
                     keyfile and str(tmp_path / keyfile))
        except ValueError as e:
            return ("error", str(e))
        return ("ok", cfg)

    assert outcome(ttls.maybe_tls) == outcome(jtls.maybe_tls)


def test_cli_refuses_half_a_pair():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "triton_client_tpu_torch.server", "--device",
         "cpu", "--ssl-certfile", COMMITTED.certfile], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert "--ssl-certfile and --ssl-keyfile must be given together" in \
        out.stderr


def test_cli_fleet_serves_tls_on_every_worker(tmp_path):
    """``--frontends 2`` with the committed pair: the shared HTTP port and
    each worker's metrics port serve HTTPS, and both workers answer."""
    from triton_client_tpu_torch.server.testing import cli_http_port, \
        free_port

    # a fixed port: under --frontends each worker binds --http-port, and
    # port 0 would give each one of its own
    port, mport = free_port(), free_port()
    log = tmp_path / "fleet.log"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TRITON_TPU_")}
    env["PYTHONPATH"] = REPO
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "triton_client_tpu_torch.server",
             "--device", "cpu", "--http-port", str(port), "--frontends", "2",
             "--grpc-port", str(free_port()),
             "--metrics-port", str(mport), "--ssl-certfile",
             COMMITTED.certfile, "--ssl-keyfile", COMMITTED.keyfile],
            cwd=REPO, env=env, stdout=f, stderr=subprocess.STDOUT)
    try:
        assert cli_http_port(proc, str(log)) == port
        # both workers print their start line; wait for the second too
        end = time.monotonic() + 120
        while len(re.findall(r"serving v2 HTTPS on", log.read_text())) < 2:
            assert proc.poll() is None and time.monotonic() < end, \
                log.read_text()
            time.sleep(0.1)
        ctx = ssl_mod.create_default_context(cafile=COMMITTED.certfile)
        for i in range(2):
            with urllib.request.urlopen(
                    f"https://127.0.0.1:{mport + i}/metrics", context=ctx,
                    timeout=30) as r:
                assert r.status == 200
        seen = set()
        for _ in range(40):
            with thttp.InferenceServerClient(
                    f"127.0.0.1:{port}", ssl=True,
                    ssl_options={"ca_certs": COMMITTED.certfile}) as c:
                _check(c.infer("simple", _simple(thttp)))
            for i in range(2):
                with urllib.request.urlopen(
                        f"https://127.0.0.1:{mport + i}/metrics",
                        context=ctx, timeout=30) as r:
                    text = r.read().decode()
                if re.search(r'nv_inference_request_success\{[^}]*'
                             r'model="simple"[^}]*\} [1-9]', text):
                    seen.add(i)
            if seen == {0, 1}:
                break
        assert seen == {0, 1}
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def test_generate_self_signed_falls_back_to_openssl(tmp_path, monkeypatch):
    """Without ``cryptography`` the ``openssl`` command makes the pair,
    which serves; without either the error names both."""
    import builtins
    import shutil

    real_import = builtins.__import__

    def no_cryptography(name, *args, **kwargs):
        if name == "cryptography" or name.startswith("cryptography."):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_cryptography)
    if shutil.which("openssl") is not None:
        cfg = ttls.generate_self_signed(str(tmp_path), days=2)
        ctx = cfg.ssl_context()
        assert isinstance(ctx, ssl_mod.SSLContext)
        cert = ssl_mod._ssl._test_decode_cert(cfg.certfile)
        assert ("IP Address", "127.0.0.1") in cert["subjectAltName"]
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="'cryptography'.*'openssl'"):
        ttls.generate_self_signed(str(tmp_path))
