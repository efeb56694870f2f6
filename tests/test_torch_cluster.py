"""The port's cluster client against the reference's, on the CPU.

The counterpart of ``tests/test_cluster.py``:

* the state machines with no server, held against the reference's where
  both give an answer: ``rendezvous_rank`` orders and the sequences a
  membership change moves, for seeded ids; the breaker's states for one
  record and clock script; ``LeastOutstanding``'s picks for a seed;
  ``HedgePolicy``'s delays for the same observations;
  ``merge_cost_snapshots`` on the same snapshots, junk included;
* the pool (pins, exclusion, total outage) and ``close`` (nothing made
  after it);
* end to end on the port's ``ClusterHarness`` (three in-process servers of
  ``custom_identity_int32``): round robin's spread, delegation, plugin
  fan-out, streams refused, gRPC-Web, a replica killed mid c = 8 run with
  zero caller errors, sequences pinned across another replica's outage,
  the breaker's cycle, active probing, quarantine reroute, hedging's
  straggler, ``get_costs`` summed over the replicas, and ``close`` leaving
  no thread.

Breaker tests pass an explicit clock or poll a condition; the hedging test
gives the straggler 400 ms against a 50 ms hedge.
"""

import random
import threading
import time

import numpy as np
import pytest

from triton_client_tpu import _telemetry as jtel
from triton_client_tpu import cluster as jcluster
from triton_client_tpu.cluster import _client as jclient
from triton_client_tpu_torch import _telemetry as ttel
from triton_client_tpu_torch import cluster as tcluster
from triton_client_tpu_torch import http as thttp
from triton_client_tpu_torch._resilience import RetryPolicy
from triton_client_tpu_torch.cluster import (CircuitBreaker, ClusterClient,
                                             EndpointPool, HedgePolicy,
                                             LeastOutstanding, RoundRobin,
                                             make_policy, rendezvous_rank)
from triton_client_tpu_torch.cluster import _client as tclient
from triton_client_tpu_torch.models import zoo as tzoo
from triton_client_tpu_torch.server.chaos import ChaosInjector
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import ClusterHarness
from triton_client_tpu_torch.utils import InferenceServerException

MODEL = "custom_identity_int32"


def _registry_factory():
    r = ModelRegistry()
    r.register_model(tzoo.make_custom_identity_int32())
    return r


@pytest.fixture(scope="module")
def cluster():
    ch = ClusterHarness(_registry_factory, n=3)
    ch.start()
    yield ch
    ch.stop()


@pytest.fixture
def full_fleet(cluster):
    """Tests kill and restart replicas: each starts with all three up and
    no chaos."""
    for i, h in enumerate(cluster.harnesses):
        if h is None:
            cluster.restart(i)
        else:
            h.core.chaos = None
    return cluster


def _x(n=4):
    return np.arange(n, dtype=np.int32).reshape(1, n)


def _inputs(x):
    i = thttp.InferInput("INPUT0", list(x.shape), "INT32")
    i.set_data_from_numpy(x)
    return [i]


def _policy(**kw):
    kw.setdefault("max_attempts", 3)
    kw.setdefault("retry_infer", True)
    kw.setdefault("initial_backoff_s", 0.01)
    kw.setdefault("seed", 0)
    return RetryPolicy(**kw)


def _wait_for(cond, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def _endpoint_totals():
    return {e["endpoint"]: e["success"] + e["failure"]
            for e in ttel.telemetry().snapshot()["endpoints"]}


def _endpoint_state(url):
    for e in ttel.telemetry().snapshot()["endpoints"]:
        if e["endpoint"] == url:
            return e["state"]
    return None


def _hedge_totals():
    snap = ttel.telemetry().snapshot()["hedges"]
    return (sum(h["hedges"] for h in snap), sum(h["wins"] for h in snap))


# -- the surface --------------------------------------------------------------

def test_exports_the_reference_s_all():
    assert tcluster.__all__ == jcluster.__all__
    for name in tcluster.__all__:
        assert getattr(tcluster, name) is not getattr(jcluster, name)


# -- rendezvous ranks, against the reference ----------------------------------

def _seeded_ids(seed, n=200):
    rng = random.Random(seed)
    return [rng.randrange(1, 1 << 63) for _ in range(n)] + list(range(1, 33))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rendezvous_rank_is_the_reference_s(seed):
    rng = random.Random(100 + seed)
    urls = [f"10.0.{rng.randrange(256)}.{i}:{8000 + rng.randrange(3)}"
            for i in range(rng.randrange(2, 7))]
    for sid in _seeded_ids(seed):
        assert rendezvous_rank(sid, urls) == \
            jcluster.rendezvous_rank(sid, urls)


@pytest.mark.parametrize("seed", [0, 1])
def test_membership_change_moves_the_reference_s_sequences(seed):
    """Dropping one endpoint moves exactly the sequences pinned to it, to
    their rank-1 endpoint, in both packages alike."""
    urls = ["h1:8000", "h2:8000", "h3:8000", "h4:8000"]
    for victim in urls:
        rest = [u for u in urls if u != victim]
        moved = {}
        for pkg in (tcluster, jcluster):
            moved[pkg.__name__] = sorted(
                sid for sid in _seeded_ids(seed)
                if pkg.rendezvous_rank(sid, urls)[0]
                != pkg.rendezvous_rank(sid, rest)[0])
        assert moved["triton_client_tpu_torch.cluster"] == \
            moved["triton_client_tpu.cluster"]
        for sid in moved["triton_client_tpu.cluster"]:
            full = rendezvous_rank(sid, urls)
            assert full[0] == victim
            assert rendezvous_rank(sid, rest)[0] == full[1]


def test_pins_spread_over_every_endpoint():
    urls = ["h1:8000", "h2:8000", "h3:8000"]
    pins = {s: rendezvous_rank(s, urls)[0] for s in range(64)}
    assert set(pins.values()) == set(urls)


# -- policies -----------------------------------------------------------------

def test_round_robin_cycles():
    pool = EndpointPool(["a:1", "b:1", "c:1"], policy="round_robin")
    assert [pool.pick().url for _ in range(6)] == ["a:1", "b:1", "c:1"] * 2


def test_least_outstanding_prefers_idle():
    pool = EndpointPool(["a:1", "b:1"], policy=LeastOutstanding(seed=0))
    for _ in range(5):
        pool.endpoint("a:1").acquire()
    assert all(pool.pick().url == "b:1" for _ in range(20))


@pytest.mark.parametrize("seed", [0, 7])
def test_least_outstanding_picks_are_the_reference_s(seed):
    """The same seed and the same loads give the reference's picks."""
    urls = [f"e{i}:1" for i in range(5)]
    pools = [EndpointPool(urls, policy=LeastOutstanding(seed=seed)),
             jcluster.EndpointPool(urls,
                                   policy=jcluster.LeastOutstanding(seed))]
    load = random.Random(seed)
    picks = [[], []]
    for _ in range(100):
        url = urls[load.randrange(len(urls))]
        for pool, out in zip(pools, picks):
            pool.endpoint(url).acquire()
            out.append(pool.pick().url)
    assert picks[0] == picks[1]


def test_make_policy():
    assert isinstance(make_policy("round_robin"), RoundRobin)
    assert isinstance(make_policy("least_outstanding"), LeastOutstanding)
    rr = RoundRobin()
    assert make_policy(rr) is rr
    with pytest.raises(ValueError):
        make_policy("fastest_guess")


def test_duplicate_urls_rejected():
    with pytest.raises(ValueError):
        EndpointPool(["a:1", "a:1"])
    with pytest.raises(ValueError):
        EndpointPool([])


def test_comma_separated_urls():
    assert EndpointPool("a:1, b:1,c:1").urls == ["a:1", "b:1", "c:1"]


# -- the breaker, against the reference ---------------------------------------

# (operation, argument, now): record(ok) or try_admit() at a clock
_BREAKER_SCRIPTS = {
    "full-cycle": [("record", False, 0.0), ("record", False, 0.1),
                   ("record", False, 0.2), ("admit", None, 0.25),
                   ("admit", None, 1.3), ("admit", None, 1.31),
                   ("record", True, 1.4), ("admit", None, 1.5)],
    "trial-fails": [("record", False, 0.0), ("record", False, 0.0),
                    ("record", False, 0.0), ("admit", None, 2.0),
                    ("record", False, 2.1), ("admit", None, 2.5),
                    ("admit", None, 3.2), ("record", True, 3.3)],
    "stale-success": [("record", False, 0.0), ("record", False, 0.0),
                      ("record", False, 0.0), ("record", True, 0.1),
                      ("admit", None, 0.2), ("admit", None, 1.2),
                      ("record", True, 1.3)],
    "never-three": [("record", False, 0.0), ("record", False, 0.0),
                    ("record", True, 0.0), ("record", False, 0.0),
                    ("record", False, 0.0), ("admit", None, 0.0)],
}


@pytest.mark.parametrize("script", sorted(_BREAKER_SCRIPTS))
def test_breaker_states_are_the_reference_s(script):
    seen = []
    for cls in (CircuitBreaker, jcluster.CircuitBreaker):
        br = cls("e:1", failure_threshold=3, reset_timeout_s=1.0)
        trail = []
        for op, arg, now in _BREAKER_SCRIPTS[script]:
            if op == "record":
                br.record(arg, now=now)
                trail.append(br.state)
            else:
                trail.append((br.would_allow(now=now), br.try_admit(now=now),
                              br.state))
        seen.append((trail, list(br.history)))
    assert seen[0] == seen[1]


def test_breaker_full_cycle():
    br = CircuitBreaker("e:1", failure_threshold=3, reset_timeout_s=0.1)
    assert br.state == "closed" and br.would_allow()
    br.record(False)
    br.record(False)
    assert br.state == "closed"
    br.record(False)
    assert br.state == "open"
    assert not br.would_allow() and not br.try_admit()
    time.sleep(0.12)
    assert br.would_allow()
    assert br.try_admit()
    assert br.state == "half_open"
    assert not br.try_admit()
    br.record(True)
    assert br.history == ["closed", "open", "half_open", "closed"]
    assert _endpoint_state("e:1") == "closed"


def test_would_allow_never_mutates():
    br = CircuitBreaker("e:1", failure_threshold=1, reset_timeout_s=0.0)
    br.record(False)
    for _ in range(5):
        assert br.would_allow()
    assert br.state == "open"


# -- the pool -----------------------------------------------------------------

def test_pinned_sequence_not_displaced_by_busy_half_open_trial():
    pool = EndpointPool(["h1:8000", "h2:8000", "h3:8000"],
                        policy="round_robin", failure_threshold=1,
                        reset_timeout_s=0.0)
    pin = pool.sticky_rank(7)[0]
    br = pool.endpoint(pin).breaker
    br.record(ok=False)
    assert br.try_admit()
    assert br.state == "half_open"
    assert pool.pick(sequence_id=7).url == pin


def test_pool_pick_honors_pin_and_fails_over_in_rank_order():
    pool = EndpointPool(["h1:8000", "h2:8000", "h3:8000"],
                        policy="round_robin")
    ranked = pool.sticky_rank(42)
    assert pool.pick(sequence_id=42).url == ranked[0]
    br = pool.endpoint(ranked[0]).breaker
    for _ in range(br.failure_threshold):
        br.record(ok=False)
    assert pool.pick(sequence_id=42).url == ranked[1]
    assert pool.pick(sequence_id=42, exclude=[ranked[1]]).url == ranked[2]


def test_open_breaker_is_skipped():
    pool = EndpointPool(["a:1", "b:1"], policy="round_robin")
    bad = pool.endpoint("a:1")
    for _ in range(bad.breaker.failure_threshold):
        pool.record(bad, ok=False)
    assert all(pool.pick().url == "b:1" for _ in range(5))
    assert _endpoint_state("a:1") == "open"


def test_exclusion_prefers_other_endpoint_unless_it_empties_the_pool():
    pool = EndpointPool(["a:1", "b:1"], policy="round_robin")
    assert all(pool.pick(exclude=["a:1"]).url == "b:1" for _ in range(5))
    one = EndpointPool(["a:1"], policy="round_robin")
    assert one.pick(exclude=["a:1"]).url == "a:1"


def test_total_outage_still_routes():
    pool = EndpointPool(["a:1", "b:1"], reset_timeout_s=60.0)
    for url in pool.urls:
        ep = pool.endpoint(url)
        for _ in range(ep.breaker.failure_threshold):
            pool.record(ep, ok=False)
    assert pool.pick().url in ("a:1", "b:1")


def test_probe_success_on_a_closed_breaker_is_dropped():
    pool = EndpointPool(["a:1"], failure_threshold=2)
    br = pool.endpoint("a:1").breaker
    br.record(False)
    pool.probe_ok("a:1", True)  # must not zero the failure count
    br.record(False)
    assert br.state == "open"


# -- the hedge delay, against the reference -----------------------------------

def test_hedge_delay_default_until_warm_then_quantile():
    h = HedgePolicy(quantile=0.95, default_delay_s=0.5, min_samples=8)
    jh = jcluster.HedgePolicy(quantile=0.95, default_delay_s=0.5,
                              min_samples=8)
    ep = EndpointPool(["a:1"]).endpoint("a:1")
    jep = jcluster.EndpointPool(["a:1"]).endpoint("a:1")
    assert h.delay_s(ep, "m") == jh.delay_s(jep, "m") == 0.5
    rng = np.random.default_rng(3)
    for i, v in enumerate(rng.lognormal(-4.0, 0.6, 100)):
        ep.observe("m", float(v))
        jep.observe("m", float(v))
        assert h.delay_s(ep, "m") == jh.delay_s(jep, "m"), i
    assert h.delay_s(ep, "other") == 0.5


def test_hedge_policy_validates_quantile():
    for q in (0.0, 1.0, 1.5):
        with pytest.raises(ValueError):
            HedgePolicy(quantile=q)


# -- the cost merge, against the reference ------------------------------------

def test_merge_cost_snapshots_is_the_reference_s():
    rng = np.random.default_rng(5)
    snaps = []
    for r in range(4):
        models = {}
        for m in ("bert_large", "longctx_tpu"):
            models[m] = {t: {"device_us": float(rng.random() * 1e4),
                             "flops": float(rng.random() * 1e12),
                             "tokens": int(rng.integers(0, 1000)),
                             "kv_byte_seconds": float(rng.random())}
                         for t in ("gold", "bulk")[:1 + r % 2]}
        snaps.append({"enabled": r == 2, "models": models})
    snaps += [None, {"enabled": False}, {"models": {"x": "junk"}},
              {"models": {"x": {"t": {"tokens": "n/a", "flops": "bad",
                                      "device_us": 5}}}}]
    assert tclient.merge_cost_snapshots(snaps) == \
        jclient.merge_cost_snapshots(snaps)
    assert tclient.merge_cost_snapshots([]) == {"enabled": False,
                                                "models": {}}


# -- close --------------------------------------------------------------------

def test_lazy_executor_after_close_raises_not_leaks():
    c = ClusterClient(["a:1", "b:1"], protocol="http")
    c.close()
    with pytest.raises(InferenceServerException, match="closed"):
        c._hedge_executor()
    assert c._executor is None


def test_lazy_client_after_close_raises_not_leaks():
    c = ClusterClient(["a:1", "b:1"], protocol="http")
    c.close()
    ep = c.pool.endpoint("a:1")
    with pytest.raises(InferenceServerException, match="closed"):
        c._client_for(ep)
    with pytest.raises(InferenceServerException, match="closed"):
        c._probe_client_for(ep, timeout_s=1.0)
    with pytest.raises(InferenceServerException, match="closed"):
        c.probe_all()
    assert c._clients == {} and c._probe_clients == {}


def test_close_shuts_down_created_executor():
    c = ClusterClient(["a:1", "b:1"], protocol="http")
    ex = c._hedge_executor()
    assert c._hedge_executor() is ex
    c.close()
    assert c._executor is None
    with pytest.raises(RuntimeError):
        ex.submit(lambda: None)


def test_protocol_checked():
    with pytest.raises(InferenceServerException):
        ClusterClient(["a:1"], protocol="carrier-pigeon")


# -- end to end: routing and delegation ---------------------------------------

def test_round_robin_spreads_traffic(full_fleet):
    before = _endpoint_totals()
    with ClusterClient(full_fleet.http_urls, protocol="http",
                       policy="round_robin") as c:
        x = _x()
        for _ in range(6):
            r = c.infer(MODEL, _inputs(x))
            np.testing.assert_array_equal(r.as_numpy("OUTPUT0"), x)
    after = _endpoint_totals()
    for url, h in zip(full_fleet.http_urls, full_fleet.harnesses):
        assert after.get(url, 0) - before.get(url, 0) == 2, url


def test_distribution_matches_each_server_s_statistics(full_fleet):
    """The client's per-endpoint counts equal each replica's own count of
    the requests it answered."""
    def served():
        return [h.core.statistics(MODEL)[0]["inference_stats"]["success"]
                ["count"] for h in full_fleet.harnesses]

    before, t0 = served(), _endpoint_totals()
    with ClusterClient(full_fleet.http_urls, protocol="http",
                       policy=LeastOutstanding(seed=1)) as c:
        x = _x()
        for _ in range(12):
            c.infer(MODEL, _inputs(x))
    after, t1 = served(), _endpoint_totals()
    assert [a - b for a, b in zip(after, before)] == \
        [t1.get(u, 0) - t0.get(u, 0) for u in full_fleet.http_urls]
    assert sum(after) - sum(before) == 12


def test_health_and_metadata_delegation(full_fleet):
    with ClusterClient(full_fleet.http_urls, protocol="http",
                       retry_policy=_policy()) as c:
        assert c.is_server_ready() is True
        assert c.is_model_ready(MODEL) is True
        assert c.get_model_metadata(MODEL)["name"] == MODEL
        stats = c.get_inference_statistics(MODEL)
        assert stats["model_stats"][0]["name"] == MODEL
        with pytest.raises(AttributeError):
            c.no_such_method


def test_broadcast_reaches_every_endpoint(full_fleet):
    with ClusterClient(full_fleet.http_urls, protocol="http") as c:
        c.update_log_settings({"log_verbose_level": 1})
        assert all(h.core.log_settings["log_verbose_level"] == 1
                   for h in full_fleet.harnesses)
        c.update_log_settings({"log_verbose_level": 0})


def test_plugin_fans_out_to_endpoint_clients(full_fleet):
    from triton_client_tpu_torch._auth import BasicAuth

    plugin = BasicAuth("user", "pass")
    with ClusterClient(full_fleet.http_urls, protocol="http",
                       policy="round_robin") as c:
        x = _x()
        c.infer(MODEL, _inputs(x))  # one client exists before the plugin
        c.register_plugin(plugin)
        for _ in range(3):
            c.infer(MODEL, _inputs(x))
        assert len(c._clients) == 3
        assert all(cl.plugin() is plugin for cl in c._clients.values())
        c.unregister_plugin()
        assert all(cl.plugin() is None for cl in c._clients.values())


def test_streaming_is_rejected(full_fleet):
    with ClusterClient(full_fleet.http_urls, protocol="http") as c:
        with pytest.raises(InferenceServerException, match="per-connection"):
            c.start_stream(callback=lambda *a: None)


def test_grpc_cluster_round_trip(full_fleet):
    from triton_client_tpu_torch import grpc as tgrpc

    x = _x()
    i = tgrpc.InferInput("INPUT0", [1, 4], "INT32")
    i.set_data_from_numpy(x)
    routes = []
    with ClusterClient(full_fleet.http_urls, protocol="grpc",
                       policy="round_robin",
                       on_route=lambda u, m, s: routes.append(u)) as c:
        assert c.is_server_ready() is True
        for _ in range(3):
            r = c.infer(MODEL, [i])
            np.testing.assert_array_equal(r.as_numpy("OUTPUT0"), x)
        assert c.probe_all(timeout_s=2.0) == {
            u: True for u in full_fleet.http_urls}
    assert sorted(routes) == sorted(full_fleet.http_urls)


def test_infer_many_routes_one_flight_to_one_endpoint(full_fleet):
    routes = []
    with ClusterClient(full_fleet.http_urls, protocol="http",
                       policy="round_robin",
                       on_route=lambda u, m, s: routes.append(u)) as c:
        flights = [[_inputs(_x() + k)] for k in range(3)]
        for items in flights:
            out = c.infer_many(MODEL, [it[0] for it in [items]] * 4)
            assert len(out) == 4
        assert c.infer_many(MODEL, []) == []
    assert routes == full_fleet.http_urls


def test_get_costs_sums_every_replica(full_fleet):
    with ClusterClient(full_fleet.http_urls, protocol="http") as c:
        per = [thttp.InferenceServerClient(u) for u in full_fleet.http_urls]
        try:
            merged = c.get_costs()
            snaps = [p.get_costs() for p in per]
        finally:
            for p in per:
                p.close()
    assert merged == tclient.merge_cost_snapshots(snaps)


# -- end to end: failover -----------------------------------------------------

def _concurrent_run(client, n_requests, concurrency, mid_action=None,
                    mid_after=None):
    """A closed loop at ``concurrency`` that fires ``mid_action`` once
    ``mid_after`` requests were claimed; returns the callers' errors."""
    errors = []
    claimed = [0]
    lock = threading.Lock()
    fired = threading.Event()
    x = _x()

    def worker():
        try:
            while True:
                with lock:
                    if claimed[0] >= n_requests:
                        return
                    claimed[0] += 1
                    k = claimed[0]
                if mid_action is not None and k == mid_after \
                        and not fired.is_set():
                    fired.set()
                    mid_action()
                r = client.infer(MODEL, _inputs(x))
                np.testing.assert_array_equal(r.as_numpy("OUTPUT0"), x)
        except Exception as e:  # noqa: BLE001 - what the test counts
            errors.append(e)

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return errors


def test_kill_one_replica_zero_caller_visible_errors(full_fleet):
    """Three replicas, one killed (and one with latency chaos) mid c = 8
    run under RetryPolicy(3): no caller error, the dead one's breaker
    open, the survivors absorbing the run."""
    urls = full_fleet.http_urls
    victim = urls[1]
    full_fleet.chaos(2, ChaosInjector(rate=0.3, kinds=["latency"],
                                      latency_ms=30.0, seed=5))
    before = _endpoint_totals()
    with ClusterClient(urls, protocol="http", policy="round_robin",
                       retry_policy=_policy()) as c:
        errors = _concurrent_run(c, n_requests=96, concurrency=8,
                                 mid_action=lambda: full_fleet.kill(1),
                                 mid_after=24)
        states = c.pool.states()
    assert errors == []
    assert states[victim] == "open"
    assert _endpoint_state(victim) == "open"
    after = _endpoint_totals()
    dead = after.get(victim, 0) - before.get(victim, 0)
    survivors = [u for u in urls if u != victim]
    for u in survivors:
        assert after.get(u, 0) - before.get(u, 0) > dead / 2, u
    assert sum(after.get(u, 0) - before.get(u, 0)
               for u in survivors) >= 96 - dead


def test_sequences_stay_pinned_across_other_endpoint_outage(full_fleet):
    urls = full_fleet.http_urls
    routes = []
    with ClusterClient(urls, protocol="http", retry_policy=_policy(),
                       on_route=lambda u, m, s: routes.append((s, u))) as c:
        pins = {s: c.pool.sticky_rank(s)[0] for s in range(1, 11)}
        victim = pins[1]
        tracked = next(s for s, p in pins.items() if p != victim)
        moved = next(s for s, p in pins.items() if p == victim)
        x = _x()
        for s in (tracked, moved):
            c.infer(MODEL, _inputs(x), sequence_id=s, sequence_start=True)
        full_fleet.kill(urls.index(victim))
        for _ in range(4):
            for s in (tracked, moved):
                c.infer(MODEL, _inputs(x), sequence_id=s)
        for s in (tracked, moved):
            c.infer(MODEL, _inputs(x), sequence_id=s, sequence_end=True)
        assert {u for s, u in routes if s == tracked} == {pins[tracked]}
        rank1 = c.pool.sticky_rank(moved)[1]
        moved_routes = [u for s, u in routes if s == moved]
        assert set(moved_routes) <= {victim, rank1}
        assert moved_routes[-1] == rank1


def test_breaker_cycle_closed_open_half_open_closed(full_fleet):
    urls = full_fleet.http_urls
    victim = urls[2]
    with ClusterClient(urls, protocol="http", policy="round_robin",
                       retry_policy=_policy(), reset_timeout_s=1.0) as c:
        x = _x()
        for _ in range(6):
            c.infer(MODEL, _inputs(x))
        assert _endpoint_state(victim) == "closed"
        full_fleet.kill(2)
        for _ in range(12):
            c.infer(MODEL, _inputs(x))
        assert c.pool.states()[victim] == "open"
        assert _endpoint_state(victim) == "open"
        full_fleet.restart(2)
        time.sleep(1.1)  # past the reset timeout
        for _ in range(12):
            c.infer(MODEL, _inputs(x))
        assert c.pool.states()[victim] == "closed"
        assert _endpoint_state(victim) == "closed"
        it = iter(c.pool.endpoint(victim).breaker.history)
        assert all(s in it for s in ["closed", "open", "half_open",
                                     "closed"])


def test_active_probing_evicts_and_readmits(full_fleet):
    urls = full_fleet.http_urls
    victim = urls[0]
    with ClusterClient(urls, protocol="http", reset_timeout_s=0.5,
                       health_interval_s=0.15) as c:
        full_fleet.kill(0)
        _wait_for(lambda: c.pool.states()[victim] == "open",
                  timeout=15.0, msg="the probes' eviction")
        full_fleet.restart(0)
        _wait_for(lambda: c.pool.states()[victim] == "closed",
                  timeout=15.0, msg="the probes' readmission")


# -- end to end: quarantine ---------------------------------------------------

def _quarantine(h) -> None:
    """Quarantine MODEL on one replica and keep it so: the port's core
    probes on its own thread and releases a model that has no probe, so a
    probe that fails is registered, on a short backoff (the refusal's
    pushback, which the retry waits)."""
    faults = h.core.device_faults
    faults.probe_backoff_s = faults.probe_backoff_max_s = 0.05
    faults.register_probe(MODEL, lambda: False)
    faults.quarantine(MODEL, "drill")


def _release(cluster) -> None:
    for h in cluster.harnesses:
        h.core.device_faults.forget(MODEL)

def test_quarantined_replicas_are_routed_around(full_fleet):
    """Two replicas quarantine the model (a 503 naming it, sent before any
    compute): under the default policy, which does not retry infer, each
    request still reroutes, every retry excluding the refusing replica."""
    urls = full_fleet.http_urls
    healthy = 2
    for i, h in enumerate(full_fleet.harnesses):
        if i != healthy:
            _quarantine(h)
    try:
        with ClusterClient(urls, protocol="http", policy="round_robin",
                           retry_policy=RetryPolicy(
                               max_attempts=3, initial_backoff_s=0.01,
                               seed=0)) as c:
            picks = []
            orig_pick = c._pool.pick

            def spy(*args, **kwargs):
                ep = orig_pick(*args, **kwargs)
                picks.append((tuple(kwargs.get("exclude", ())), ep.url))
                return ep

            c._pool.pick = spy
            x = _x()
            rerouted = 0
            for _ in range(4):
                picks.clear()
                r = c.infer(MODEL, _inputs(x))
                np.testing.assert_array_equal(r.as_numpy("OUTPUT0"), x)
                for (excluded, _), (_, prev) in zip(picks[1:], picks):
                    assert prev in excluded
                assert picks[-1][1] == urls[healthy]
                rerouted += len(picks) > 1
            assert rerouted >= 1
    finally:
        _release(full_fleet)


def test_all_replicas_quarantined_fails_typed(full_fleet):
    for h in full_fleet.harnesses:
        _quarantine(h)
    try:
        with ClusterClient(full_fleet.http_urls, protocol="http",
                           retry_policy=RetryPolicy(
                               max_attempts=3, initial_backoff_s=0.01,
                               seed=0)) as c:
            with pytest.raises(InferenceServerException) as e:
                c.infer(MODEL, _inputs(_x()))
        assert "quarantined" in str(e.value)
        assert e.value.status() == "503"
    finally:
        _release(full_fleet)


# -- end to end: hedging ------------------------------------------------------

def test_hedge_cuts_straggler_tail(full_fleet):
    """Replica 0 answers 400 ms late; hedged at 50 ms, nine requests take
    well under the 1.2 s its three would alone, each counted hedged and
    won."""
    urls = full_fleet.http_urls
    full_fleet.chaos(0, ChaosInjector(rate=1.0, kinds=["latency"],
                                      latency_ms=400.0, seed=3))
    h0, w0 = _hedge_totals()
    x = _x()
    with ClusterClient(urls, protocol="http", policy="round_robin",
                       hedge=HedgePolicy(default_delay_s=0.05,
                                         min_samples=1 << 30)) as c:
        t0 = time.perf_counter()
        for _ in range(9):
            r = c.infer(MODEL, _inputs(x), hedge=True)
            np.testing.assert_array_equal(r.as_numpy("OUTPUT0"), x)
        elapsed = time.perf_counter() - t0
    assert elapsed < 1.2, elapsed
    h1, w1 = _hedge_totals()
    assert h1 - h0 >= 3 and w1 - w0 >= 3


def test_hedge_gated_on_idempotency(full_fleet):
    with ClusterClient(full_fleet.http_urls, protocol="http",
                       policy="round_robin",
                       hedge=HedgePolicy(default_delay_s=0.0)) as c:
        before = _hedge_totals()
        c.infer(MODEL, _inputs(_x()))
        assert _hedge_totals() == before
        # the retry policy's opt-in arms it
        c.infer(MODEL, _inputs(_x()), retry_policy=_policy())
        c.infer(MODEL, _inputs(_x()), retry_policy=_policy(), hedge=False)
    assert _hedge_totals()[0] - before[0] <= 1


def test_sequences_never_hedge(full_fleet):
    with ClusterClient(full_fleet.http_urls, protocol="http",
                       hedge=HedgePolicy(default_delay_s=0.0),
                       retry_policy=_policy()) as c:
        before = _hedge_totals()
        c.infer(MODEL, _inputs(_x()), sequence_id=9, sequence_start=True,
                sequence_end=True)
        assert _hedge_totals() == before


def test_close_leaves_no_thread(full_fleet):
    """Hedges, probes and a prober thread: after close every thread the
    client started is gone."""
    before = set(threading.enumerate())
    c = ClusterClient(full_fleet.http_urls, protocol="http",
                      hedge=HedgePolicy(default_delay_s=0.0),
                      retry_policy=_policy(), health_interval_s=0.05)
    for _ in range(6):
        c.infer(MODEL, _inputs(_x()))
    c.probe_all()
    assert c._executor is not None and c._probe_executor is not None
    c.close()
    assert c._clients == {} and c._probe_clients == {}
    _wait_for(lambda: not [t for t in set(threading.enumerate()) - before
                           if t.name.startswith("tc-torch-")
                           and t.is_alive()],
              timeout=10.0, msg="the client's threads to end")


def test_journey_events_on_an_endpoint_switch(full_fleet, tmp_path):
    """A retry on another replica drops an ENDPOINT_SWITCH event and the
    victim's trip a BREAKER_OPEN on the journey's trace."""
    import json

    path = tmp_path / "client.jsonl"
    tel = ttel.telemetry()
    tel.enable_tracing(str(path))
    try:
        full_fleet.kill(0)
        with ClusterClient(full_fleet.http_urls, protocol="http",
                           policy="round_robin", failure_threshold=1,
                           retry_policy=_policy()) as c:
            c.infer(MODEL, _inputs(_x()))
    finally:
        tel.disable_tracing()
    names = [s["name"] for line in path.read_text().splitlines()
             for s in json.loads(line)["spans"]]
    assert "ENDPOINT_SWITCH" in names and "BREAKER_OPEN" in names


def test_cluster_families_render_like_the_reference_s():
    """The four cluster families, rendered and in the snapshot, on the
    same script in both registries."""
    out = []
    for mod in (ttel, jtel):
        reg = mod.ClientTelemetry()
        reg.record_endpoint_request("a:1", True)
        reg.record_endpoint_request("a:1", False)
        reg.record_endpoint_request("b:1", True)
        reg.set_endpoint_state("b:1", "half_open")
        reg.set_endpoint_state("a:1", "open")
        reg.record_hedge("m", "http")
        reg.record_hedge("m", "http", won=True)
        text = reg.render_prometheus()
        snap = reg.snapshot()
        out.append(([ln for ln in text.splitlines()
                     if "endpoint" in ln or "hedge" in ln],
                    snap["endpoints"], snap["hedges"]))
        reg.reset()
        assert reg.snapshot()["endpoints"] == []
    assert out[0] == out[1]
