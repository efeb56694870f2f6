"""QoS of the port (``triton_client_tpu_torch/server/qos.py``) against the
JAX package's, on the CPU.

* token buckets on an injected clock: the same verdicts and pushback;
* ``QosManager``: tier mapping, tier limits, pushback, tenant buckets and
  overrides, the tenant cardinality cap, ``parse_tenant_limit``,
  ``tenant_from_headers`` and ``apply_request_priority``, each equal to the
  reference's on the same inputs;
* ``TieredQueue``: the same seeded puts give the same items in the same
  order (strict priority and weighted fair), the same preemption victims;
  the port's queue is thread-safe (a getter blocks, then wakes; a timeout
  raises ``queue.Empty``);
* admission over the wire, on both servers: a best-effort arrival at its
  tier's bound is shed with the same status, text and pushback headers
  while tier 0 still enters; a tenant's rate limit; the tenant and tier
  each client sends land on the server's flight record;
* preemption in the batcher: a tier-0 arrival at a full queue takes the
  slot of the newest queued best-effort request, whose caller gets the 429
  once.
"""

import queue
import random
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import triton_client_tpu.grpc as jgrpc
from triton_client_tpu.models import zoo as jzoo
from triton_client_tpu.server import qos as jqos
from triton_client_tpu.server import types as jtypes
from triton_client_tpu.server.registry import ModelRegistry as JaxRegistry
from triton_client_tpu.server.testing import ServerHarness as JaxHarness
from triton_client_tpu_torch import grpc as tgrpc
from triton_client_tpu_torch import http as thttp
from triton_client_tpu_torch.models import zoo as tzoo
from triton_client_tpu_torch.server import qos as tqos
from triton_client_tpu_torch.server import types as ttypes
from triton_client_tpu_torch.server.core import InferenceCore
from triton_client_tpu_torch.server.model import PyModel, make_config
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import ServerHarness
from triton_client_tpu_torch.server.types import (InferError, InferRequest,
                                                  InputTensor)
from triton_client_tpu_torch.utils import InferenceServerException

MODEL = "custom_identity_int32"
PKGS = {"jax": jqos, "port": tqos}


# -- token buckets -----------------------------------------------------------

def _bucket_trace(mod, rate, burst, times):
    b = mod.TokenBucket(rate, burst)
    b._stamp = 0.0
    return [b.acquire(now=t) for t in times]


@pytest.mark.parametrize("rate,burst", [(2.0, 3.0), (10.0, None),
                                        (100.0, 0.5), (0.5, 2.0)])
def test_token_bucket_verdicts_equal(rate, burst):
    rng = np.random.default_rng(5)
    times = np.cumsum(rng.exponential(0.2, 60)).tolist()
    times = [0.0, 0.0, 0.0, 0.0] + times
    want = _bucket_trace(jqos, rate, burst, times)
    got = _bucket_trace(tqos, rate, burst, times)
    assert got == pytest.approx(want)


def test_token_bucket_burst_then_throttle_then_refill():
    b = tqos.TokenBucket(rate=2.0, burst=3.0)
    b._stamp = 0.0
    assert [b.acquire(now=0.0) for _ in range(3)] == [None] * 3
    assert b.acquire(now=0.0) == pytest.approx(0.5)
    assert b.acquire(now=0.5) is None  # one token refilled


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_token_bucket_invalid_rate(pkg):
    with pytest.raises(ValueError):
        PKGS[pkg].TokenBucket(0.0)


# -- QosManager --------------------------------------------------------------

def test_tier_mapping_and_limits_equal():
    for tiers in (1, 2, 4, 7):
        for frac in (0.25, 0.5, 1.0):
            j = jqos.QosManager(tiers=tiers, best_effort_fraction=frac)
            t = tqos.QosManager(tiers=tiers, best_effort_fraction=frac)
            for p in (-3, 0, 1, 2, 3, 9, "x", None):
                assert t.tier_of(p) == j.tier_of(p)
            for tier in range(tiers):
                for limit in (0, 1, 2, 16, 100):
                    assert t.tier_limit(tier, limit) == \
                        j.tier_limit(tier, limit)
            assert t.best_effort_tier == j.best_effort_tier


def test_pushback_depth_proportional_equal():
    for base, depth, limit in [(0.25, 0, 16), (0.25, 8, 16), (0.0, 3, 4),
                               (1.0, 5, 0), (0.5, -1, 4)]:
        assert tqos.QosManager.pushback_s(base, depth, limit) == \
            jqos.QosManager.pushback_s(base, depth, limit)


def test_tenant_buckets_and_overrides_equal(monkeypatch):
    seq = ["a", "spammy", "a", "spammy", "free", "spammy", "b", "a"]
    out = {}
    for pkg, mod in PKGS.items():
        clock = [100.0]
        monkeypatch.setattr(mod.time, "monotonic", lambda: clock[0])
        q = mod.QosManager(tenant_rate=2.0, tenant_burst=1.0,
                           tenant_rates={"spammy": (1.0, 1.0),
                                         "free": (0.0, None)})
        verdicts = []
        for i, tenant in enumerate(seq):
            clock[0] = 100.0 + 0.1 * i
            verdicts.append(q.admit_tenant(tenant))
        q.set_tenant_rate("a", 0.0)
        verdicts.append(q.admit_tenant("a"))
        out[pkg] = verdicts
        monkeypatch.undo()
    assert out["port"] == pytest.approx(out["jax"])
    assert out["port"][-1] is None  # the override applies at once


def test_no_rate_means_unlimited():
    q = tqos.QosManager()
    assert all(q.admit_tenant("t") is None for _ in range(100))


def test_tenant_cardinality_capped_equal():
    res = {}
    for pkg, mod in PKGS.items():
        q = mod.QosManager(tenant_rate=1.0, tenant_burst=1.0)
        q.MAX_TRACKED_TENANTS = 3
        for i in range(6):
            q.count_request(f"t{i}", 0)
            q.count_rejected("m", f"t{i}", 1)
        res[pkg] = (q.tenant_request_counts(), q.rejected_counts(),
                    [q.admit_tenant(f"x{i}") is None for i in range(3)])
    assert res["port"] == res["jax"]
    assert ("~overflow", 0) in res["port"][0]


@pytest.mark.parametrize("spec", ["gold=100:0.5", "gold=5", "a=0", "x=1:2",
                                  "junk", "=3", "a=", "a=-1", "a=1:0",
                                  "a=z"])
def test_parse_tenant_limit_equal(spec):
    def run(mod):
        try:
            return mod.parse_tenant_limit(spec)
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(tqos) == run(jqos)


@pytest.mark.parametrize("header,auth", [
    ("gold", None), ("", "Basic dXNlcjpwdw=="), (None, "Basic Ym9i"),
    (None, "Basic !!!"), (None, "Bearer abc"), (None, None),
    ("", "basic OnB3")])
def test_tenant_from_headers_equal(header, auth):
    assert tqos.tenant_from_headers(header, auth) == \
        jqos.tenant_from_headers(header, auth)


@pytest.mark.parametrize("raw", [None, 0, 3, "2", -1, "x", 1.5])
def test_apply_request_priority_equal(raw):
    def run(types):
        req = types.InferRequest(model_name="m", parameters=(
            {} if raw is None else {"priority": raw, "k": 1}))
        try:
            types.apply_request_priority(req)
        except types.InferError as e:
            return ("InferError", str(e), e.http_status)
        return req.priority, req.parameters

    assert run(ttypes) == run(jtypes)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_bad_manager_settings_fail(pkg):
    mod = PKGS[pkg]
    for kw in ({"tiers": 0}, {"best_effort_fraction": 0.0},
               {"best_effort_fraction": 1.5}, {"weights": [1]},
               {"tiers": 2, "weights": [1, 0]}):
        with pytest.raises(ValueError):
            mod.QosManager(**kw)


# -- TieredQueue ---------------------------------------------------------------

def _queue_ops(seed, tiers, n):
    """A seeded sequence of puts, pops and preemptions."""
    rng = random.Random(seed)
    ops = []
    for i in range(n):
        r = rng.random()
        if r < 0.55:
            ops.append(("put", f"i{i}", rng.randrange(-1, tiers + 1)))
        elif r < 0.9:
            ops.append(("pop",))
        else:
            ops.append(("preempt", rng.randrange(tiers)))
    return ops


def _run_queue(q, ops, pop):
    out = []
    for op in ops:
        if op[0] == "put":
            q.put_nowait(op[1], tier=op[2])
        elif op[0] == "pop":
            out.append(pop(q) if not q.empty() else None)
        else:
            out.append(("preempted", q.preempt_lower(op[1])))
        out.append(tuple(q.depths()))
    while not q.empty():
        out.append(pop(q))
    return out


@pytest.mark.parametrize("tiers,weights", [(1, None), (3, None), (4, None),
                                           (2, [2, 1]), (4, [8, 4, 2, 1]),
                                           (3, [1, 1, 5])])
@pytest.mark.parametrize("seed", range(4))
def test_tiered_queue_same_items_in_the_same_order(tiers, weights, seed):
    ops = _queue_ops(seed, tiers, 300)
    want = _run_queue(jqos.TieredQueue(tiers, weights), ops,
                      lambda q: q.get_nowait())
    got = _run_queue(tqos.TieredQueue(tiers, weights), ops,
                     lambda q: q.get(timeout=0))
    assert got == want


def test_strict_priority_fifo_and_preempt_floor():
    q = tqos.TieredQueue(4)
    for item, tier in [("t0", 0), ("be_old", 3), ("t2", 2), ("be_new", 3)]:
        q.put_nowait(item, tier=tier)
    assert q.preempt_lower(3) is None  # strictly below only
    assert [q.preempt_lower(0) for _ in range(4)] == \
        ["be_new", "be_old", "t2", None]
    assert q.qsize() == 1 and q.depth(0) == 1 and q.get(timeout=0) == "t0"


def test_get_blocks_then_wakes_and_times_out():
    q = tqos.TieredQueue(2)
    t0 = time.monotonic()
    with pytest.raises(queue.Empty):
        q.get(timeout=0.05)
    assert time.monotonic() - t0 >= 0.045
    threading.Timer(0.05, lambda: q.put_nowait("x", tier=1)).start()
    assert q.get(timeout=5) == "x"
    # several getters: each put wakes one
    got = []
    threads = [threading.Thread(target=lambda: got.append(q.get(timeout=5)))
               for _ in range(3)]
    for t in threads:
        t.start()
    for i in range(3):
        q.put_nowait(i, tier=i % 2)
    for t in threads:
        t.join(timeout=10)
    assert sorted(got) == [0, 1, 2] and q.empty()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_bad_weights(pkg):
    with pytest.raises(ValueError):
        PKGS[pkg].TieredQueue(2, weights=[1])
    with pytest.raises(ValueError):
        PKGS[pkg].TieredQueue(2, weights=[1, 0])


# -- admission over the wire, on both servers ----------------------------------

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
    yield
    hs = request.node.funcargs.get("servers")
    if hs is None:
        return
    for pkg, h in hs.items():
        stats = h.core.registry.get(MODEL).stats
        end = time.monotonic() + 10
        while stats.pending_count and time.monotonic() < end:
            time.sleep(0.01)
        h.core.queue_limits.clear()
        h.core.qos = PKGS[pkg].QosManager()


def _x(n=4):
    return np.arange(n, dtype=np.int32).reshape(1, n)


def _inputs(mod, x):
    i = mod.InferInput("INPUT0", list(x.shape), "INT32")
    i.set_data_from_numpy(x)
    return [i]


def _post(url, priority=None, tenant=None):
    """One raw HTTP infer: (status, body text, pushback headers)."""
    import json

    body = {"inputs": [{"name": "INPUT0", "datatype": "INT32",
                        "shape": [1, 4], "data": [0, 1, 2, 3]}]}
    if priority is not None:
        body["parameters"] = {"priority": priority}
    headers = {"Content-Type": "application/json"}
    if tenant:
        headers["triton-tenant"] = tenant
    req = urllib.request.Request(f"http://{url}/v2/models/{MODEL}/infer",
                                 data=json.dumps(body).encode(),
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, "", {}
    except urllib.error.HTTPError as e:
        text = json.loads(e.read())["error"]
        return e.code, text, {k: e.headers.get(k) for k in (
            "Retry-After", "triton-retry-after-ms")}


def _occupy(h, n, priority=3, tenant="bulk", delay_ms=800):
    """``n`` slow requests pending on ``h``'s model."""
    def run():
        try:
            with thttp.InferenceServerClient(h.http_url) as c:
                c.infer(MODEL, _inputs(thttp, _x()),
                        parameters={"execute_delay_ms": delay_ms},
                        priority=priority, tenant=tenant)
        except Exception:  # noqa: BLE001 - occupancy is what matters
            pass

    threads = [threading.Thread(target=run, daemon=True) for _ in range(n)]
    for t in threads:
        t.start()
    stats = h.core.registry.get(MODEL).stats
    end = time.monotonic() + 10
    while stats.pending_count < n:
        assert time.monotonic() < end, "occupiers never became pending"
        time.sleep(0.005)
    return threads


def test_best_effort_shed_first_tier0_admitted(servers):
    """The queue at the best-effort bound: a best-effort arrival sheds with
    the same status, text and pushback headers from both servers, and
    tier 0 still enters."""
    out = {}
    for pkg, h in servers.items():
        h.core.queue_limits[MODEL] = 4  # tier-3 bound = 2
        threads = _occupy(h, 2)
        try:
            shed = _post(h.http_url, priority=3, tenant="bulk")
            ok = _post(h.http_url, priority=0, tenant="gold")
        finally:
            for t in threads:
                t.join(timeout=30)
        out[pkg] = (shed, ok[0], h.core.qos.rejected_counts())
    assert out["port"] == out["jax"]
    shed, ok, counts = out["port"]
    assert shed[0] == 429 and ok == 200
    assert "is full for tier 3" in shed[1]
    assert shed[2]["Retry-After"] == "1"
    assert counts == {(MODEL, "bulk", 3): 1}


def test_queue_full_shed_equal_over_grpc(servers):
    """Tier 0 at a full queue with nothing lower queued: RESOURCE_EXHAUSTED
    with the same text from both servers, and its pushback as
    ``retry-after-ms`` (the reference's gRPC port, the port's gRPC-Web)."""
    errs = {}
    for pkg, h in servers.items():
        h.core.queue_limits[MODEL] = 1
        threads = _occupy(h, 1, priority=0, tenant="gold")
        try:
            if pkg == "jax":
                c = jgrpc.InferenceServerClient(h.grpc_url)
                ins = _inputs(jgrpc, _x())
            else:
                c = tgrpc.InferenceServerClient(h.http_url)
                ins = _inputs(tgrpc, _x())
            # either package's InferenceServerException
            with pytest.raises(Exception) as ei:
                c.infer(MODEL, ins, tenant="gold")
            c.close()
        finally:
            for t in threads:
                t.join(timeout=30)
        errs[pkg] = ei.value
    for e in errs.values():
        assert e.status() == "StatusCode.RESOURCE_EXHAUSTED"
        assert "is full for tier 0" in e.message()
    assert errs["port"].message() == errs["jax"].message()
    assert errs["port"].retry_after_s == errs["jax"].retry_after_s == 0.5


def test_tenant_rate_limit_isolated_per_tenant(servers):
    out = {}
    for pkg, h in servers.items():
        h.core.qos = PKGS[pkg].QosManager(
            tiers=4, tenant_rates={"spammy": (1.0, 1.0)})
        first = _post(h.http_url, tenant="spammy")
        second = _post(h.http_url, tenant="spammy")
        polite = _post(h.http_url, tenant="polite")
        out[pkg] = (first[0], second[0], second[1], polite[0],
                    h.core.qos.rejected_counts())
        assert second[2]["Retry-After"] == "1"
        assert 0 < int(second[2]["triton-retry-after-ms"]) <= 1000
    assert out["port"] == out["jax"]
    assert out["port"][:2] == (200, 429)


@pytest.mark.parametrize("protocol", ["http", "grpc"])
def test_tenant_and_priority_reach_the_flight_record(servers, protocol):
    """Each client's ``tenant`` and ``priority`` resolve to the same
    flight-record tenant and tier on both servers; a basic-auth username
    is the tenant where no header names one."""
    import base64

    recs = {}
    for pkg, h in servers.items():
        if protocol == "grpc" and pkg == "jax":
            c, mod = jgrpc.InferenceServerClient(h.grpc_url), jgrpc
        else:
            mod = tgrpc if protocol == "grpc" else thttp
            c = mod.InferenceServerClient(h.http_url)
        c.infer(MODEL, _inputs(mod, _x()), priority=2, tenant="gold")
        auth = {"authorization" if protocol == "grpc" else "Authorization":
                "Basic " + base64.b64encode(b"alice:pw").decode()}
        c.infer(MODEL, _inputs(mod, _x()), headers=auth, priority=9)
        c.close()
        recent = h.core.flight_recorder.snapshot(model=MODEL)["recent"]
        recs[pkg] = [(r["tenant"], r["tier"]) for r in recent[-2:]]
    assert recs["port"] == recs["jax"] == [("gold", 2), ("alice", 3)]


def test_async_infer_carries_tenant(servers):
    h = servers["port"]
    with thttp.InferenceServerClient(h.http_url, concurrency=2) as c:
        c.async_infer(MODEL, _inputs(thttp, _x()), tenant="async",
                      priority=1).get_result(timeout=30)
    with tgrpc.InferenceServerClient(h.http_url) as c:
        c.async_infer(MODEL, _inputs(tgrpc, _x()), tenant="grpc_async",
                      priority=1).get_result(timeout=30)
    recent = h.core.flight_recorder.snapshot(model=MODEL)["recent"][-2:]
    assert [(r["tenant"], r["tier"]) for r in recent] == \
        [("async", 1), ("grpc_async", 1)]


# -- preemption in the batcher -------------------------------------------------

def test_tier0_preempts_queued_best_effort():
    """A tier-0 arrival at a full queue evicts the newest queued
    best-effort request from the batcher's lane (429 to its caller, once)
    and takes its slot."""
    release = threading.Event()
    cfg = make_config("blocky", inputs=[("IN", "INT32", [-1])],
                      outputs=[("OUT", "INT32", [-1])], max_batch_size=1,
                      preferred_batch_sizes=[1], instance_kind="KIND_CPU")

    def fn(inputs, params):
        release.wait(timeout=20)
        return {"OUT": inputs["IN"]}

    registry = ModelRegistry()
    registry.register_model(PyModel(cfg, fn))
    core = InferenceCore(registry)
    try:
        def req(priority, tenant):
            r = InferRequest(model_name="blocky", inputs=[InputTensor(
                "IN", "INT32", (1, 1), data=np.array([[1]], np.int32))])
            r.priority, r.tenant = priority, tenant
            return r

        results = [None] * 7

        def send(i, priority, tenant):
            try:
                results[i] = core.infer(req(priority, tenant))
            except InferError as e:
                results[i] = e

        stats = registry.get("blocky").stats
        core.queue_limits["blocky"] = 16
        # 4 execute (blocked), 1 rides the batcher's hand, 1 is queued
        threads = [threading.Thread(target=send, args=(i, 3, "bulk"))
                   for i in range(6)]
        for t in threads:
            t.start()
        end = time.monotonic() + 10
        while stats.pending_count < 6 or \
                core.qos_queue_depths().get(("blocky", 3), 0) < 1:
            assert time.monotonic() < end, "backlog never formed"
            time.sleep(0.005)
        core.queue_limits["blocky"] = 6  # now full
        tier0 = threading.Thread(target=send, args=(6, 0, "gold"))
        tier0.start()
        end = time.monotonic() + 10
        while core.qos.rejected_counts().get(("blocky", "bulk", 3), 0) < 1:
            assert time.monotonic() < end, "no preemption"
            time.sleep(0.005)
        # the slot transferred: the victim's pending count is gone
        end = time.monotonic() + 10
        while stats.pending_count != 6:
            assert time.monotonic() < end, stats.pending_count
            time.sleep(0.005)
        release.set()
        for t in threads + [tier0]:
            t.join(timeout=30)
        preempted = [r for r in results[:6] if isinstance(r, InferError)]
        assert len(preempted) == 1 and preempted[0].http_status == 429
        assert "preempted by higher-priority traffic (tier 3)" in \
            str(preempted[0])
        assert preempted[0].retry_after_s is not None
        assert not isinstance(results[6], InferError)
        assert core.qos.rejected_counts() == {("blocky", "bulk", 3): 1}
        assert stats.pending_count == 0
    finally:
        release.set()
        core.shutdown()
