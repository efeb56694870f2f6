"""The memory governor and the ingress cap of the port
(``triton_client_tpu_torch/server/memory.py``, the frontends) against the
JAX package's, on the CPU.

* the ledger and the verdicts: the same seeded script of admissions,
  response bytes, releases, pressure windows and device-headroom gates
  through both packages' governors gives the same verdicts, ledger, shed
  counts, metric rows and snapshot (an injected clock and device stats);
* the ``mem_pressure`` chaos kind: the same seeded draws, the core
  actuating the governor and stamping the flight record;
* the core: an in-envelope memory shed stamps ``shed_reason`` on the
  flight record; a request admitted by the byte gate and shed on the queue
  bound hands its bytes back;
* the wire, on both servers: a payload over its tier's share of the
  budget is a 413 (never retried), one refused by the ledger's fill a 429
  with pushback, both with the same text, over HTTP and gRPC; the ingress
  cap's 413 and headers, and a kept-alive connection that goes on serving
  after it; the ``nv_mem_*`` families and the ``memory`` section of the
  debug route;
* the drill: an oversized best-effort burst at twice the budget beside
  ``mem_pressure`` chaos sheds only with typed 429/413, while a tier-0
  stream sees no error and the ledger stays within the budget.
"""

import json
import random
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest

import triton_client_tpu.grpc as jgrpc
import triton_client_tpu.http as jhttp
from triton_client_tpu.models import zoo as jzoo
from triton_client_tpu.server import chaos as jchaos
from triton_client_tpu.server import memory as jmemory
from triton_client_tpu.server import qos as jqos
from triton_client_tpu.server.registry import ModelRegistry as JaxRegistry
from triton_client_tpu.server.testing import ServerHarness as JaxHarness
from triton_client_tpu_torch import grpc as tgrpc
from triton_client_tpu_torch import http as thttp
from triton_client_tpu_torch._resilience import (RetryPolicy,
                                                 is_oversize_error)
from triton_client_tpu_torch.models import zoo as tzoo
from triton_client_tpu_torch.server import chaos as tchaos
from triton_client_tpu_torch.server import memory as tmemory
from triton_client_tpu_torch.server import qos as tqos
from triton_client_tpu_torch.server.core import InferenceCore
from triton_client_tpu_torch.server.model import PyModel, make_config
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import ServerHarness
from triton_client_tpu_torch.server.types import (InferError, InferRequest,
                                                  InputTensor)
from triton_client_tpu_torch.utils import InferenceServerException

MODEL = "custom_identity_int32"
BUDGET = 64 << 10
PKGS = {"jax": (jmemory, jqos), "port": (tmemory, tqos)}


# -- the ledger and the verdicts -----------------------------------------------

def _script(seed, n=400):
    rng = random.Random(seed)
    ops, t = [], 100.0
    for _ in range(n):
        t += rng.random() * 0.05
        r = rng.random()
        tenant = f"t{rng.randrange(5)}"
        model = rng.choice(["m", "n"])
        if r < 0.45:
            ops.append(("admit", model, tenant, rng.randrange(4),
                        rng.choice([0, 10, 100, 400, 900, 2000]), t))
        elif r < 0.6:
            ops.append(("add", model, tenant, rng.randrange(500)))
        elif r < 0.85:
            ops.append(("release", model, tenant, rng.randrange(1200)))
        elif r < 0.9:
            ops.append(("pressure", rng.choice([0.5, 0.25, -1.0, 2.0]),
                        rng.random() * 0.5, t))
        else:
            ops.append(("hbm", model, rng.choice([0, 50, 81, 400, 900]),
                        tenant, rng.randrange(4)))
    return ops


def _run_script(pkg, ops, budget, hbm):
    memory, qos = PKGS[pkg]
    g = memory.MemoryGovernor(budget_bytes=budget,
                              hbm_stats_fn=lambda: hbm)
    q = qos.QosManager(tiers=4, best_effort_fraction=0.5)
    out = []
    for op in ops:
        if op[0] == "admit":
            _, model, tenant, tier, nbytes, t = op
            out.append(g.try_admit(model, tenant, tier, nbytes, qos=q,
                                   base_pushback_s=0.25, now=t))
        elif op[0] == "add":
            g.add(*op[1:])
        elif op[0] == "release":
            g.release(*op[1:])
        elif op[0] == "pressure":
            g.inject_pressure(op[1], op[2], now=op[3])
            out.append(g.effective_budget(now=op[3]))
        else:
            _, model, nbytes, tenant, tier = op
            try:
                g.admit_hbm(model, nbytes, tenant=tenant, tier=tier)
                out.append(None)
            except Exception as e:  # noqa: BLE001 - either package's
                out.append((str(e), e.http_status, e.retry_after_s,
                            e.shed_reason))
        out.append((g.inflight_bytes, dict(g.inflight_by_model),
                    dict(g.inflight_by_tenant)))
    snap = g.snapshot()
    snap.pop("pressure_active")  # read against the wall clock
    return out, dict(g.shed), g.peak_inflight_bytes, g.metric_rows(), snap


@pytest.mark.parametrize("budget", [0, 1000, 3000])
@pytest.mark.parametrize("seed", range(3))
def test_governor_script_equal(seed, budget):
    hbm = {"dev:0": {"bytes_limit": 1000, "bytes_in_use": 100},
           "dev:1": {"bytes_limit": 1000, "bytes_in_use": 300}}
    ops = _script(seed)
    assert _run_script("port", ops, budget, hbm) == \
        _run_script("jax", ops, budget, hbm)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_ledger_reserve_add_release_and_peak(pkg):
    memory, qos = PKGS[pkg]
    g = memory.MemoryGovernor(budget_bytes=1000)
    assert g.try_admit("m", "t", 0, 400, qos=None) is None
    g.add("m", "t", 300)
    assert (g.inflight_bytes, g.inflight_by_model) == (700, {"m": 700})
    g.release("m", "t", 700)
    assert g.inflight_by_model == {} and g.peak_inflight_bytes == 700
    g.release("m", "t", 999)
    assert g.inflight_bytes == 0


def test_verdicts_tier_aware_and_permanent():
    q = tqos.QosManager(tiers=4, best_effort_fraction=0.5)
    g = tmemory.MemoryGovernor(budget_bytes=1000)
    assert g.try_admit("m", "t", 0, 400, qos=q) is None
    assert g.try_admit("m", "bulk", 3, 200, qos=q) is not None
    assert g.try_admit("m", "gold", 0, 200, qos=q) is None
    assert g.try_admit("m", "t", 0, 2000, qos=q)[1] is True
    assert g.try_admit("m", "t", 3, 600, qos=q)[1] is True
    assert g.try_admit("m", "t", 0, 500, qos=q)[1] is False
    g.inject_pressure(0.5, duration_s=60.0, now=100.0)
    assert g.effective_budget(now=101.0) == 500
    assert g.effective_budget(now=161.0) == 1000


def test_tenant_cardinality_folds_into_overflow():
    g = tmemory.MemoryGovernor(budget_bytes=100)
    for i in range(g.MAX_TRACKED_TENANTS + 200):
        assert g.try_admit("m", f"r{i}", 0, 1000, qos=None) is not None
    assert g.shed[("m", g.OVERFLOW_TENANT, 0, "host")] == 200
    assert len(g.shed) == g.MAX_TRACKED_TENANTS + 1


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_pressure_active_is_clock_true_on_track_only_governor(pkg):
    memory, _ = PKGS[pkg]
    g = memory.MemoryGovernor(budget_bytes=0)
    g.inject_pressure(0.5, duration_s=3600.0)
    assert g.snapshot()["pressure_active"] is True
    g2 = memory.MemoryGovernor(budget_bytes=0)
    g2.inject_pressure(0.5, duration_s=0.0)
    assert g2.snapshot()["pressure_active"] is False


def test_hbm_gate_inert_without_stats_and_on_failure():
    g = tmemory.MemoryGovernor()
    assert g.hbm_headroom() is None  # no card here: the gate is inert
    g.admit_hbm("m", 1 << 40)

    def boom():
        raise RuntimeError("gauge off")

    g.hbm_stats_fn = boom
    g.admit_hbm("m", 1 << 40)
    assert g.shed == {} and g.metric_rows()["hbm_headroom"] == []
    assert tmemory.hbm_stats() == {}


def test_pin_ledgers_equal():
    res = {}
    for pkg, (memory, _) in PKGS.items():
        g = memory.MemoryGovernor()
        a = g.kv_pin("m", 100, tenant="t", now=1.0)
        b = g.cache_pin("m", 50, tenant="u", now=2.0)
        c = g.kv_pin("n", 0, now=2.0)
        mid = g.snapshot()["kv"]
        res[pkg] = (a, b, c, mid, g.kv_unpin(a, now=3.5),
                    g.cache_unpin(b, now=4.0), g.kv_unpin(a, now=5.0),
                    g.cache_unpin(99), g.metric_rows(),
                    g.snapshot()["kv"])
    assert res["port"] == res["jax"]


# -- the mem_pressure kind -------------------------------------------------------

@pytest.mark.parametrize("kinds", [("mem_pressure",),
                                   ("latency", "mem_pressure", "error")])
def test_mem_pressure_draws_equal(kinds):
    draws = {}
    for pkg, mod in (("jax", jchaos), ("port", tchaos)):
        inj = mod.ChaosInjector(rate=0.4, kinds=kinds, seed=11,
                                pressure_s=2.5, pressure_factor=0.3)
        draws[pkg] = [None if f is None else (f.kind, f.latency_s,
                                              f.pressure_factor, f.status)
                      for f in (inj.decide("m") for _ in range(200))]
    assert draws["port"] == draws["jax"]
    assert ("mem_pressure", 2.5, 0.3, 503) in draws["port"]


def test_core_actuates_pressure_and_stamps_flight():
    registry = ModelRegistry()
    registry.register_model(tzoo.make_custom_identity_int32())
    core = InferenceCore(registry)
    try:
        core.memory.budget_bytes = 1 << 20
        core.chaos = tchaos.ChaosInjector(
            rate=1.0, kinds=("mem_pressure",), seed=3, max_faults=1,
            pressure_s=30.0, pressure_factor=0.5)
        req = InferRequest(model_name=MODEL, inputs=[InputTensor(
            "INPUT0", "INT32", (1, 4), data=np.ones((1, 4), np.int32))])
        resp = core.infer(req)
        assert resp.outputs[0].data is not None
        assert core.memory.effective_budget() == 1 << 19
        rec = core.flight_recorder.snapshot(model=MODEL)["recent"][-1]
        assert rec["chaos"] == "mem_pressure"
        assert rec["capture_reason"] == "chaos:mem_pressure"
    finally:
        core.shutdown()


# -- the core ------------------------------------------------------------------

def test_shed_reason_stamped_on_flight_record():
    cfg = make_config("oom_gate", inputs=[("IN", "INT32", [-1])],
                      outputs=[("OUT", "INT32", [-1])],
                      instance_kind="KIND_CPU")

    def fn(inputs, params):
        err = InferError("projected KV exceeds headroom", 429,
                         retry_after_s=1.0)
        err.shed_reason = "memory"
        raise err

    registry = ModelRegistry()
    registry.register_model(PyModel(cfg, fn))
    core = InferenceCore(registry)
    try:
        req = InferRequest(model_name="oom_gate", inputs=[InputTensor(
            "IN", "INT32", (2,), data=np.ones(2, np.int32))])
        with pytest.raises(InferError):
            core.infer(req)
        snap = core.flight_recorder.snapshot(model="oom_gate")
        assert snap["recent"][-1]["shed_reason"] == "memory"
        assert snap["recent"][-1]["outcome"] != "ok"
        assert any(o["shed_reason"] == "memory" for o in snap["outliers"])
    finally:
        core.shutdown()


def test_queue_shed_after_reservation_releases_bytes():
    release = threading.Event()
    cfg = make_config("blocky", inputs=[("IN", "INT32", [-1])],
                      outputs=[("OUT", "INT32", [-1])],
                      instance_kind="KIND_CPU")

    def fn(inputs, params):
        release.wait(timeout=20)
        return {"OUT": inputs["IN"]}

    registry = ModelRegistry()
    registry.register_model(PyModel(cfg, fn))
    core = InferenceCore(registry)

    def req():
        r = InferRequest(model_name="blocky", inputs=[InputTensor(
            "IN", "INT32", (2,), data=np.ones(2, np.int32))])
        r.wire_bytes = 1000
        return r

    try:
        core.memory.budget_bytes = 1 << 20
        core.queue_limits["blocky"] = 1
        t = threading.Thread(target=core.infer, args=(req(),))
        t.start()
        stats = registry.get("blocky").stats
        end = time.monotonic() + 10
        while stats.pending_count < 1:
            assert time.monotonic() < end
            time.sleep(0.005)
        with pytest.raises(InferError) as ei:
            core.infer(req())
        assert ei.value.http_status == 429
        assert ei.value.shed_reason is None  # a queue shed, not memory
        assert core.memory.inflight_bytes == 1000
        release.set()
        t.join(timeout=30)
        assert core.memory.inflight_bytes == 0
    finally:
        release.set()
        core.shutdown()


# -- the wire, on both servers -------------------------------------------------

@pytest.fixture(scope="module")
def servers():
    jreg = JaxRegistry()
    jreg.register_model(jzoo.make_custom_identity_int32())
    treg = ModelRegistry()
    treg.register_model(tzoo.make_custom_identity_int32())
    with JaxHarness(jreg) as jh, ServerHarness(treg) as th:
        yield {"jax": jh, "port": th}


@pytest.fixture(autouse=True)
def _clean(request):
    hs = request.node.funcargs.get("servers")
    if hs is not None:
        for pkg, h in hs.items():
            h.core.memory = PKGS[pkg][0].MemoryGovernor(budget_bytes=BUDGET)
    yield
    if hs is not None:
        for pkg, h in hs.items():
            h.core.chaos = None
            h.core.memory = PKGS[pkg][0].MemoryGovernor()


def _payload(n_int32):
    return np.zeros((1, n_int32), np.int32)


def _infer(mod, url, x, **kw):
    i = mod.InferInput("INPUT0", list(x.shape), "INT32")
    i.set_data_from_numpy(x)
    with mod.InferenceServerClient(url) as c:
        return c.infer(MODEL, [i], **kw)


def _err(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - either package's exception
        return e
    raise AssertionError("no error")


@pytest.mark.parametrize("protocol", ["http", "grpc"])
def test_over_tier_share_is_413_never_retried(servers, protocol):
    errs = {}
    for pkg, h in servers.items():
        if protocol == "grpc":
            mod, url = (jgrpc, h.grpc_url) if pkg == "jax" \
                else (tgrpc, h.http_url)
        else:
            mod, url = (jhttp if pkg == "jax" else thttp), h.http_url
        errs[pkg] = _err(lambda: _infer(mod, url, _payload(24 << 10)))
        assert h.core.memory.shed_total() == 1
        assert h.core.rejected_by_model.get(MODEL, 0) >= 1
    assert errs["port"].status() == errs["jax"].status()
    assert errs["port"].message() == errs["jax"].message()
    assert "can never be admitted" in errs["port"].message()
    assert is_oversize_error(errs["port"])
    assert not RetryPolicy(retry_infer=True).should_retry(
        errs["port"], "infer", 1)


def test_over_tier_share_not_retried_by_the_client(servers):
    """Under a retry policy the port's clients send a 413 (HTTP) or its
    RESOURCE_EXHAUSTED (gRPC) once."""
    h = servers["port"]
    for mod in (thttp, tgrpc):
        before = h.core.memory.shed_total()
        e = _err(lambda: _infer(mod, h.http_url, _payload(24 << 10),
                                retry_policy=RetryPolicy(
                                    max_attempts=3, retry_infer=True)))
        assert "can never be admitted" in str(e)
        assert h.core.memory.shed_total() == before + 1


def test_ledger_fill_is_429_with_pushback(servers):
    errs = {}
    for pkg, h in servers.items():
        gov = h.core.memory
        gov.try_admit(MODEL, "occupier", 0, 40 << 10, qos=h.core.qos)
        mod = jhttp if pkg == "jax" else thttp
        errs[pkg] = _err(lambda: _infer(mod, h.http_url, _payload(8 << 10)))
        gov.release(MODEL, "occupier", 40 << 10)
    assert errs["port"].status() == errs["jax"].status() == "429"
    assert errs["port"].message() == errs["jax"].message()
    # 0.25 s x (1 + 40 KiB / 64 KiB)
    assert errs["port"].retry_after_s == errs["jax"].retry_after_s == 0.406


def test_small_traffic_flows_and_ledger_drains(servers):
    h = servers["port"]
    for _ in range(8):
        assert _infer(thttp, h.http_url, _payload(64)).as_numpy(
            "OUTPUT0") is not None
    assert h.core.memory.inflight_bytes == 0
    assert h.core.memory.peak_inflight_bytes > 0


def test_mem_families_and_debug_surface(servers):
    fams = {}
    for pkg, h in servers.items():
        mod = jhttp if pkg == "jax" else thttp
        _err(lambda: _infer(mod, h.http_url, _payload(24 << 10),
                            tenant="whale", priority=3))
        text = urllib.request.urlopen(
            f"http://{h.http_url}/metrics", timeout=10).read().decode()
        fams[pkg] = sorted(ln for ln in text.splitlines()
                           if ln.startswith(("nv_mem_budget",
                                             "nv_mem_shed")))
        snap = json.loads(urllib.request.urlopen(
            f"http://{h.http_url}/v2/debug/device_stats",
            timeout=10).read())
        assert snap["memory"]["budget_bytes"] == BUDGET
        assert snap["memory"]["shed_total"] == 1
        assert snap["memory"]["hbm_headroom_bytes"] is None
    assert fams["port"] == fams["jax"]
    assert ('nv_mem_shed_total{model="custom_identity_int32",'
            'tenant="whale",tier="3",reason="host"} 1') in fams["port"]


# -- the ingress cap -------------------------------------------------------------

def _raw_post(port, body: bytes, headers=()):
    """One POST on a fresh socket: (status line, headers, body)."""
    s = socket.create_connection(("127.0.0.1", port), timeout=30)
    head = [f"POST /v2/models/{MODEL}/infer HTTP/1.1", "Host: x",
            f"Content-Length: {len(body)}", *headers]
    s.sendall(("\r\n".join(head) + "\r\n\r\n").encode() + body)
    f = s.makefile("rb")
    status = f.readline().decode().strip()
    hdrs = {}
    while True:
        line = f.readline().decode()
        if line in ("\r\n", ""):
            break
        k, _, v = line.partition(":")
        hdrs[k.strip().lower()] = v.strip()
    data = f.read(int(hdrs.get("content-length", 0)))
    s.close()
    return status.split(" ", 2)[1], hdrs, json.loads(data)


def test_ingress_cap_413_equal_to_reference():
    """The cap answers 413 from the declared size, with the reference's
    text and headers (its HTTP app at the same cap)."""
    from triton_client_tpu_torch.server.http_server import HttpServer

    cap = 1000
    treg = ModelRegistry()
    treg.register_model(tzoo.make_custom_identity_int32())
    core = InferenceCore(treg)
    body = json.dumps({"inputs": [{"name": "INPUT0", "datatype": "INT32",
                                   "shape": [1, 400],
                                   "data": [0] * 400}]}).encode()
    srv = HttpServer(core, "127.0.0.1", 0, max_request_bytes=cap)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        got = _raw_post(srv.server_address[1], body)
    finally:
        srv.shutdown()
        srv.server_close()
        core.shutdown()
    jreg = JaxRegistry()
    jreg.register_model(jzoo.make_custom_identity_int32())
    want = _reference_oversize(jreg, cap, body)
    assert got[0] == want[0] == "413"
    assert got[2] == want[2]
    for k in ("retry-after", "triton-retry-after-ms",
              "triton-max-request-bytes"):
        assert got[1][k] == want[1][k], k


def _reference_oversize(jreg, cap, body):
    """The reference HTTP app's answer to ``body`` at ingress cap
    ``cap``."""
    import asyncio

    from aiohttp import web

    from triton_client_tpu.server.core import InferenceCore as JaxCore
    from triton_client_tpu.server.http_server import build_app

    port = _free_port()

    async def main():
        runner = web.AppRunner(build_app(JaxCore(jreg),
                                         max_request_bytes=cap))
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", port)
        await site.start()
        try:
            return await asyncio.get_running_loop().run_in_executor(
                None, _raw_post, port, body)
        finally:
            await runner.cleanup()

    return asyncio.run(main())


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("protocol", ["http", "grpc"])
def test_kept_alive_connection_serves_on_after_the_cap(protocol):
    """An oversize request is refused (413 / RESOURCE_EXHAUSTED with the
    cap's text, never retried), and the next request on the same pooled
    client -- the same kept-alive connection -- is served."""
    treg = ModelRegistry()
    treg.register_model(tzoo.make_custom_identity_int32())
    from triton_client_tpu_torch.server.http_server import HttpServer

    core = InferenceCore(treg)
    srv = HttpServer(core, "127.0.0.1", 0, max_request_bytes=8000)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    accepted = []
    orig = srv.process_request

    def count(request, addr):
        accepted.append(addr)
        return orig(request, addr)

    srv.process_request = count
    url = f"127.0.0.1:{srv.server_address[1]}"
    mod = tgrpc if protocol == "grpc" else thttp
    try:
        with mod.InferenceServerClient(url) as c:
            x = _payload(16)
            ok = mod.InferInput("INPUT0", list(x.shape), "INT32")
            ok.set_data_from_numpy(x)
            c.infer(MODEL, [ok])
            big = mod.InferInput("INPUT0", [1, 4000], "INT32")
            big.set_data_from_numpy(_payload(4000))
            e = _err(lambda: c.infer(MODEL, [big], retry_policy=RetryPolicy(
                max_attempts=3, retry_infer=True)))
            assert "exceeds the server's max request size of 8000" in str(e)
            assert is_oversize_error(e)
            if protocol == "http":
                assert e.status() == "413" and e.retry_after_s == 1.0
            else:
                assert e.status() == "StatusCode.RESOURCE_EXHAUSTED"
            for _ in range(3):
                np.testing.assert_array_equal(
                    c.infer(MODEL, [ok]).as_numpy("OUTPUT0"), x)
        assert len(accepted) == 1  # one kept-alive connection throughout
    finally:
        srv.shutdown()
        srv.server_close()
        core.shutdown()


def test_chunked_body_over_the_cap_closes_the_connection():
    treg = ModelRegistry()
    treg.register_model(tzoo.make_custom_identity_int32())
    from triton_client_tpu_torch.server.http_server import HttpServer

    core = InferenceCore(treg)
    srv = HttpServer(core, "127.0.0.1", 0, max_request_bytes=100)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        s = socket.create_connection(("127.0.0.1", srv.server_address[1]),
                                     timeout=30)
        s.sendall(b"POST /v2/models/custom_identity_int32/infer HTTP/1.1\r\n"
                  b"Host: x\r\nTransfer-Encoding: chunked\r\n\r\n"
                  + b"".join(b"40\r\n" + b"x" * 64 + b"\r\n"
                             for _ in range(4)) + b"0\r\n\r\n")
        reply = s.makefile("rb").read()
        s.close()
        assert reply.startswith(b"HTTP/1.1 413")
        assert b"Connection: close" in reply
        assert b"max request size of 100 bytes" in reply
    finally:
        srv.shutdown()
        srv.server_close()
        core.shutdown()


def test_grpc_stream_message_over_the_cap_is_in_band_413():
    treg = ModelRegistry()
    treg.register_model(tzoo.make_custom_identity_int32())
    from triton_client_tpu_torch.server.http_server import HttpServer

    core = InferenceCore(treg)
    srv = HttpServer(core, "127.0.0.1", 0, max_request_bytes=4000)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    import queue as q

    done = q.Queue()
    try:
        c = tgrpc.InferenceServerClient(f"127.0.0.1:{srv.server_address[1]}")
        c.start_stream(callback=lambda result, error: done.put(
            (result, error)))
        for n in (16, 2000, 16):
            i = tgrpc.InferInput("INPUT0", [1, n], "INT32")
            i.set_data_from_numpy(_payload(n))
            c.async_stream_infer(MODEL, [i])
        answers = [done.get(timeout=30) for _ in range(3)]
        c.stop_stream()
        c.close()
        assert answers[0][1] is None and answers[2][1] is None
        err = answers[1][1]
        assert err.status() == "StatusCode.RESOURCE_EXHAUSTED"
        assert is_oversize_error(err)
    finally:
        srv.shutdown()
        srv.server_close()
        core.shutdown()


# -- the drill -----------------------------------------------------------------

def test_oversized_burst_with_mem_pressure_recovers_clean(servers):
    """Best-effort giants at twice the byte budget beside seeded
    mem_pressure: sheds only typed 429/413 (no reset), a tier-0 stream
    without error, the ledger within the budget plus one response, and
    the budget back once the windows lift."""
    h = servers["port"]
    core = h.core
    core.chaos = tchaos.ChaosInjector(
        rate=0.2, kinds=("mem_pressure",), seed=42, max_faults=3,
        pressure_s=0.3, pressure_factor=0.5)
    big, small = _payload(12 << 10), _payload(64)
    stop = threading.Event()
    shed, resets, tier0_errors, tier0_ok = [], [], [], [0]

    def whale(idx):
        with thttp.InferenceServerClient(h.http_url) as c:
            i = thttp.InferInput("INPUT0", list(big.shape), "INT32")
            i.set_data_from_numpy(big)
            while not stop.is_set():
                try:
                    c.infer(MODEL, [i], priority=3, tenant=f"whale{idx}")
                except InferenceServerException as e:
                    (shed if e.status() in ("429", "413") else resets) \
                        .append(e.status())
                except Exception as e:  # noqa: BLE001 - a reset
                    resets.append(repr(e))

    def gold():
        with thttp.InferenceServerClient(h.http_url) as c:
            i = thttp.InferInput("INPUT0", list(small.shape), "INT32")
            i.set_data_from_numpy(small)
            while not stop.is_set():
                try:
                    c.infer(MODEL, [i], priority=0, tenant="gold")
                    tier0_ok[0] += 1
                except Exception as e:  # noqa: BLE001
                    tier0_errors.append(repr(e))

    threads = [threading.Thread(target=whale, args=(i,), daemon=True)
               for i in range(4)] + [threading.Thread(target=gold,
                                                      daemon=True)]
    for t in threads:
        t.start()
    time.sleep(2.0)
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert tier0_errors == [] and tier0_ok[0] >= 10
    assert resets == [] and shed
    assert core.memory.peak_inflight_bytes <= BUDGET + big.nbytes
    assert core.memory.shed_total() == len(shed)
    time.sleep(0.3)
    assert core.memory.effective_budget() == BUDGET
    assert core.memory.inflight_bytes == 0
