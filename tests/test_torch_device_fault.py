"""The port's device-fault containment against the JAX package's, on the
CPU.

* ``DeviceFaultManager`` (``server/core.py``): one script of faults,
  recoveries, aborts, quarantines and probe results gives the same
  ``snapshot()`` and export rows in both packages; the probe backoff
  doubles, escalates once, and a model with no probe is released.
* The ``device_error`` chaos kind: dispatch-plane only, bounded by
  ``max_faults``; ``ChaosDeviceError`` is not an ``InferError`` and reads
  as a failed CUDA launch where the reference's reads as XLA's.
* The batched decode worker, both packages on the tiny ``llama_tpu``
  preset in f32 with the reference's weights: a seeded transient
  ``device_error`` against a cohort recovers every stream with zero
  caller errors and the reference's undisturbed tokens; a fault on a
  tick resumes the emitted prefix; the recovery budget's typed 500; a
  persistent fault quarantines and a probe releases; a bucket that cannot
  be rebuilt quarantines at once and closes; the stall watchdog; the
  generate alias; a warm cache survives, and a retired block is dropped
  and recovered cold.
* The wire: a quarantined model is not ready and refused with a 503, its
  pushback and the ``quarantined`` marker, on HTTP and gRPC-Web, as the
  reference's server answers; the core's prober releases it.
* ``--device-fault-*``, ``--tick-stall-ms`` and ``--kv-cache-bytes``.

Every wait polls with a timeout of 30 s or more and no time ratio is
asserted: the driver runs six test processes at once.
"""

import dataclasses
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from triton_client_tpu.models import decode as jdec
from triton_client_tpu.models import language as jlang
from triton_client_tpu.models import transformer as jtr
from triton_client_tpu.models import zoo as jzoo
from triton_client_tpu.server import chaos as jchaos
from triton_client_tpu.server import metrics as jmetrics
from triton_client_tpu.server.core import DeviceFaultManager as JaxManager
from triton_client_tpu.server.registry import ModelRegistry as JaxRegistry
from triton_client_tpu.server.testing import ServerHarness as JaxHarness
from triton_client_tpu_torch import grpc as tgrpc
from triton_client_tpu_torch import http as thttp
from triton_client_tpu_torch._resilience import is_quarantine_error
from triton_client_tpu_torch.models import decode as tdec
from triton_client_tpu_torch.models import language as tlang
from triton_client_tpu_torch.models import zoo as tzoo
from triton_client_tpu_torch.server import chaos as tchaos
from triton_client_tpu_torch.server import kvcache as tkv
from triton_client_tpu_torch.server import metrics as tmetrics
from triton_client_tpu_torch.server.core import DeviceFaultManager
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import ServerHarness
from triton_client_tpu_torch.server.types import InferError

MODEL = "llama_decode_tfault"
PRESET_SEED = 3
POLL_S = 30.0


def _poll(predicate, timeout_s=POLL_S, what="condition"):
    deadline = time.monotonic() + timeout_s
    while not predicate():
        if time.monotonic() > deadline:
            pytest.fail(f"timed out waiting for {what}")
        time.sleep(0.01)


# -- the state machine ------------------------------------------------------

def _manager_script(cls):
    """One script of calls on a manager (no core): each step's results and
    the snapshot, its times left out."""
    mgr = cls(threshold=3, window_s=30.0, probe_backoff_s=0.5,
              probe_backoff_max_s=2.0, escalate_after=2)
    escalations = []
    mgr.escalation_cb = lambda m, st: escalations.append(
        (m, st["probes_failed"]))
    out = []

    def snap():
        s = mgr.snapshot()
        for st in s["quarantined"].values():
            st.pop("since_s")
        return s

    out.append([mgr.record_fault("a", "step") for _ in range(2)])
    out.append((mgr.is_quarantined("a"), snap()))
    out.append(mgr.record_fault("a", "prefill", reason="boom"))
    out.append((mgr.is_quarantined("a"), snap(), mgr.metric_rows()))
    out.append(mgr.record_fault("a", "readback"))     # keeps it
    out.append(mgr.record_fault("b", "tick_stall", reason="stuck",
                                force_quarantine=True))
    mgr.record_recovered("a", 3)
    mgr.record_aborted("b")
    mgr.quarantine("b", "again")                       # refreshes reason
    out.append((snap(), mgr.metric_rows()))
    for _ in range(3):
        mgr.note_probe_result("a", False)
    out.append((snap(), list(escalations)))
    mgr.note_probe_result("a", True)
    mgr.unquarantine("b")
    out.append((snap(), mgr.metric_rows(), mgr.retry_in("a")))
    # a released model's window starts afresh
    out.append([mgr.record_fault("a", "step") for _ in range(2)])
    out.append(mgr.is_quarantined("a"))
    # no probe registered: released when the backoff is due
    mgr.quarantine("c", "drill")
    mgr.maybe_probe(time.monotonic() + 10.0)
    out.append((mgr.is_quarantined("c"), snap(), mgr.metric_rows()))
    return out


def test_state_machine_matches_reference():
    got = _manager_script(DeviceFaultManager)
    want = _manager_script(JaxManager)
    assert got == want
    assert got[1][0] is False and got[3][0] is True


@pytest.mark.parametrize("cls", [DeviceFaultManager, JaxManager],
                         ids=["port", "jax"])
def test_window_slides_and_retry_in(cls):
    mgr = cls(threshold=2, window_s=0.05, probe_backoff_s=5.0)
    mgr.record_fault("m", "step")
    time.sleep(0.12)
    assert not mgr.record_fault("m", "step")
    assert mgr.retry_in("m") == 0.05
    mgr.quarantine("m", "drill")
    assert 0.05 <= mgr.retry_in("m") <= 5.0


def test_probe_backoff_doubles_and_escalates_once():
    escalations = []
    mgr = DeviceFaultManager(threshold=1, probe_backoff_s=0.01,
                             probe_backoff_max_s=0.04, escalate_after=2)
    mgr.escalation_cb = lambda model, state: escalations.append(
        (model, state["probes_failed"]))
    mgr.register_probe("m", lambda: False)
    mgr.quarantine("m", "drill")
    for n in (1, 2, 3):
        _poll(lambda n=n: (mgr.maybe_probe(time.monotonic() + 10.0),
                           mgr.snapshot()["quarantined"]["m"][
                               "probes_failed"] >= n)[-1],
              what=f"probe failure {n}")
    state = mgr.snapshot()["quarantined"]["m"]
    assert state["escalated"] and state["backoff_s"] == 0.04
    assert escalations == [("m", 2)]
    mgr.register_probe("m", lambda: True)
    _poll(lambda: (mgr.maybe_probe(time.monotonic() + 10.0),
                   not mgr.is_quarantined("m"))[-1], what="probe release")


def test_fault_families_are_the_reference_s():
    assert tmetrics._FAULT_FAMILIES == jmetrics._FAULT_FAMILIES
    assert tmetrics._KVCACHE_FAMILIES == jmetrics._KVCACHE_FAMILIES
    names = {f[1] for f in tmetrics._FAULT_FAMILIES
             + tmetrics._KVCACHE_FAMILIES}
    assert len(names) == 9 and not names & set(tmetrics.UNPORTED_FAMILIES)


# -- the chaos kind ---------------------------------------------------------

@pytest.mark.parametrize("mod", [tchaos, jchaos], ids=["port", "jax"])
def test_device_error_is_dispatch_plane_only(mod):
    inj = mod.ChaosInjector(rate=1.0, kinds=["device_error"], seed=1)
    assert inj.decide("m") is None
    assert inj.maybe_device_fault("m")
    assert inj.injected_total == 1
    inj = mod.ChaosInjector(rate=1.0, kinds=["device_error"], seed=1,
                            max_faults=2)
    assert [inj.maybe_device_fault("m") for _ in range(5)] == \
        [True, True, False, False, False]


def test_mixed_pool_draws_match_reference():
    out = {}
    for pkg, mod in (("port", tchaos), ("jax", jchaos)):
        inj = mod.ChaosInjector(rate=0.5, kinds=["error", "latency",
                                                 "device_error"], seed=9)
        seq = []
        for i in range(40):
            if i % 3 == 0:
                seq.append(inj.maybe_device_fault("m"))
            else:
                f = inj.decide("m")
                seq.append(None if f is None else f.kind)
        out[pkg] = (seq, inj.injected_total)
    assert out["port"] == out["jax"]


def test_chaos_device_error_is_cuda_shaped():
    e = tchaos.ChaosDeviceError("m")
    assert isinstance(e, RuntimeError) and not isinstance(e, InferError)
    assert str(e).startswith("CUDA error: an illegal memory access")
    assert "device_error" in str(e) and "'m'" in str(e)
    assert isinstance(jchaos.ChaosDeviceError("m"), RuntimeError)


# -- the decode worker ------------------------------------------------------

def _f32_params(monkeypatch):
    for presets, dtype in ((jlang._LLAMA_PRESETS, jnp.float32),
                           (tlang._LLAMA_PRESETS, torch.float32)):
        monkeypatch.setitem(presets, "tiny", dataclasses.replace(
            presets["tiny"], dtype=dtype))
    monkeypatch.setenv("TRITON_TPU_LLAMA_PRESET", "tiny")
    monkeypatch.setenv("TRITON_TPU_DECODE_MODE", "batched")
    monkeypatch.setenv("TRITON_TPU_DECODE_SLOTS", "4")
    for var in ("TRITON_TPU_DECODE_BUCKETS", "TRITON_TPU_RECOVERY_BUDGET",
                "TRITON_TPU_TICK_STALL_MS", "TRITON_TPU_KV_QUANT",
                "TRITON_TPU_PREFILL_CHUNK", "TRITON_TPU_DECODE_STEPS",
                "TRITON_TPU_KV_CACHE_BYTES"):
        monkeypatch.delenv(var, raising=False)
    jp = jtr.init_params(jax.random.PRNGKey(PRESET_SEED),
                         jlang._LLAMA_PRESETS["tiny"])
    return {k: np.asarray(v) for k, v in jp.items()}


def _port_model(params, name=MODEL):
    return tdec.DecodeModel(name=name, device="cpu", params=params)


def _reference_tokens(win, n, name=MODEL + "_ref"):
    """The reference's undisturbed greedy stream of ``win``."""
    m = jdec.DecodeModel(name=name)
    try:
        toks, errs = _drain(m.submit_generation(win, n))
        assert not errs and len(toks) == n
        return toks
    finally:
        m._shutdown()


class _NthDispatchFault:
    """``maybe_device_fault`` fires on the Nth dispatch-boundary consult
    only (a fault after a given number of ticks)."""

    def __init__(self, n):
        self.n, self.calls = int(n), 0
        self._lock = threading.Lock()

    def maybe_device_fault(self, model_name):
        with self._lock:
            self.calls += 1
            return self.calls == self.n


def _drain(sink):
    toks, errs = [], []
    while True:
        item = sink.get(timeout=300)
        if item is None:
            return toks, errs
        if isinstance(item, Exception):
            errs.append(item)
            return toks, errs
        toks.append(int(item[0]))


def _window(seed_tokens):
    win = np.zeros((1, 128), np.int32)
    win[0, -len(seed_tokens):] = seed_tokens
    return win


@pytest.fixture
def dec(monkeypatch):
    params = _f32_params(monkeypatch)
    m = _port_model(params)
    m.test_params = params
    yield m
    m._shutdown()


def test_seeded_transient_fault_cohort_equals_the_reference(dec):
    """The drill: a seeded transient device_error against a batched
    cohort of four; every stream recovers with zero caller errors and the
    reference's undisturbed tokens; one blip does not quarantine."""
    win = _window([7, 11, 13, 17, 19])
    want = _reference_tokens(win, 6)
    mgr = DeviceFaultManager(threshold=100)
    dec.attach_device_faults(mgr)
    dec.attach_chaos(tchaos.ChaosInjector(rate=1.0, kinds=["device_error"],
                                          seed=5, max_faults=1))
    sinks = [dec.submit_generation(win, 6) for _ in range(4)]
    outs = [_drain(s) for s in sinks]
    assert dec._chaos.injected_total == 1
    for toks, errs in outs:
        assert not errs and toks == want
    snap = mgr.snapshot()
    assert snap["recovered"].get(MODEL, 0) >= 1
    assert snap["aborted"] == {} and not mgr.is_quarantined(MODEL)
    assert snap["faults"] == {f"{MODEL}/prefill": 1}


def test_mid_stream_fault_resumes_the_emitted_prefix(dec, monkeypatch):
    monkeypatch.setenv("TRITON_TPU_DECODE_STEPS", "1")
    params = dec.test_params
    m = _port_model(params, name=MODEL + "_t1")
    try:
        win = _window([3, 5, 2, 9])
        want = _reference_tokens(win, 8)
        mgr = DeviceFaultManager(threshold=100)
        m.attach_device_faults(mgr)
        stub = _NthDispatchFault(3)   # prefill, tick, the fault on tick 2
        m.attach_chaos(stub)
        toks, errs = _drain(m.submit_generation(win, 8))
        assert stub.calls >= 3 and not errs and toks == want
        snap = mgr.snapshot()
        assert snap["recovered"] == {MODEL + "_t1": 1}
        assert snap["faults"] == {f"{MODEL}_t1/step": 1}
    finally:
        m._shutdown()


def test_recovery_budget_exhaustion_is_the_reference_s_typed_500(
        monkeypatch):
    params = _f32_params(monkeypatch)
    monkeypatch.setenv("TRITON_TPU_RECOVERY_BUDGET", "1")
    out = {}
    for pkg, make, mgr_cls, inj_mod in (
            ("port", lambda: _port_model(params), DeviceFaultManager,
             tchaos),
            ("jax", lambda: jdec.DecodeModel(name=MODEL), JaxManager,
             jchaos)):
        m = make()
        try:
            mgr = mgr_cls(threshold=100)
            m.attach_device_faults(mgr)
            m.attach_chaos(inj_mod.ChaosInjector(
                rate=1.0, kinds=["device_error"], seed=2, max_faults=10))
            toks, errs = _drain(m.submit_generation(_window([1, 2, 3]), 5))
            assert len(errs) == 1
            out[pkg] = (toks, type(errs[0]).__name__, errs[0].http_status,
                        str(errs[0]), mgr.snapshot()["aborted"],
                        mgr.snapshot()["faults"])
        finally:
            m._shutdown()
    assert out["port"] == out["jax"]
    assert out["port"][2] == 500 and "recovery budget" in out["port"][3]


def test_persistent_fault_quarantines_then_probe_releases(dec):
    win = _window([4, 8, 15, 16, 23, 42])
    want = _reference_tokens(win, 5)
    mgr = DeviceFaultManager(threshold=2, probe_backoff_s=0.01,
                             probe_backoff_max_s=0.1)
    dec.attach_device_faults(mgr)
    dec.attach_chaos(tchaos.ChaosInjector(rate=1.0, kinds=["device_error"],
                                          seed=3, max_faults=3))
    toks, errs = _drain(dec.submit_generation(win, 5))
    # three faults (the prefill and two re-prefills), then a dry injector:
    # the third recovery lands, within the default budget of 3
    assert not errs and toks == want
    assert mgr.is_quarantined(MODEL)
    assert mgr.snapshot()["faults"] == {f"{MODEL}/prefill": 3}
    _poll(lambda: (mgr.maybe_probe(time.monotonic() + 10.0),
                   not mgr.is_quarantined(MODEL))[-1],
          what="probe un-quarantine")


def test_unrebuildable_cache_escalates_straight_to_quarantine(
        dec, monkeypatch):
    mgr = DeviceFaultManager(threshold=100)
    dec.attach_device_faults(mgr)
    toks, errs = _drain(dec.submit_generation(_window([2, 4]), 2))
    assert len(toks) == 2 and not errs
    dec.attach_chaos(_NthDispatchFault(1))

    def dead_context(cnt, cap, cfg):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(dec, "_new_cache_arrays", dead_context)
    toks, errs = _drain(dec.submit_generation(_window([6, 6, 6]), 4))
    assert errs   # the stream fails closed, never hangs
    assert mgr.is_quarantined(MODEL)
    snap = mgr.snapshot()
    assert snap["faults"][f"{MODEL}/rebuild"] == 1   # once, no retry loop
    assert "illegal memory access" in snap["quarantined"][MODEL]["reason"]
    with pytest.raises(InferError):
        dec.submit_generation(_window([1]), 2)


def test_tick_stall_watchdog_quarantines_a_wedged_readback(monkeypatch):
    """A readback older than the bound (here registered by hand, backdated:
    the CPU cannot wedge a dispatch; chip_smoke.py stalls the card for
    real) reports a tick_stall fault with forced quarantine, once.  The
    port watches a dispatch from before its enqueue, and on the CPU the
    enqueue is the compute, so the bound sits far above a loaded CPU's
    tick."""
    params = _f32_params(monkeypatch)
    monkeypatch.setenv("TRITON_TPU_TICK_STALL_MS", "5000")
    m = _port_model(params)
    try:
        mgr = DeviceFaultManager(threshold=100)
        m.attach_device_faults(mgr)
        toks, errs = _drain(m.submit_generation(_window([9, 9]), 3))
        assert len(toks) == 3 and not errs
        assert m._stall_s == pytest.approx(5.0)
        assert not m._watched   # every real readback was unwatched
        assert not mgr.is_quarantined(MODEL)
        with m._watch_lock:
            m._watched[999999] = [time.monotonic() - 60.0, "tick", False]
        _poll(lambda: mgr.is_quarantined(MODEL), what="tick-stall quarantine")
        snap = mgr.snapshot()
        assert snap["faults"] == {f"{MODEL}/tick_stall": 1}
        assert "cannot be killed" in snap["quarantined"][MODEL]["reason"]
        time.sleep(0.3)
        assert mgr.snapshot()["faults"] == {f"{MODEL}/tick_stall": 1}
    finally:
        m._unwatch_readback(999999)
        m._shutdown()


def test_generate_alias_quarantines_with_the_decode_worker(dec):
    gen = tdec.GenerateModel(dec, name="llama_generate_tfault")
    mgr = DeviceFaultManager(threshold=1)
    gen.model.attach_device_faults(mgr)
    dec.attach_chaos(_NthDispatchFault(1))
    toks, errs = _drain(dec.submit_generation(_window([5, 5, 5]), 4))
    assert not errs
    assert mgr.is_quarantined(MODEL)
    assert mgr.is_quarantined("llama_generate_tfault")


def test_warm_cache_survives_a_device_error(monkeypatch):
    params = _f32_params(monkeypatch)
    monkeypatch.setenv(tkv.cache_env_key(MODEL), str(64 << 20))
    m = _port_model(params)
    try:
        win = _window([7, 11, 13, 17, 19])
        want = _reference_tokens(win, 6)
        first, errs = _drain(m.submit_generation(win, 6))
        assert not errs and first == want
        cache = tkv.get(MODEL)
        blocks_before = cache.stats()["blocks"]
        assert blocks_before == 1
        mgr = DeviceFaultManager(threshold=100)
        m.attach_device_faults(mgr)
        m.attach_chaos(tchaos.ChaosInjector(
            rate=1.0, kinds=["device_error"], seed=5, max_faults=1))
        toks, errs = _drain(m.submit_generation(win, 6))
        assert not errs and toks == want
        assert mgr.snapshot()["recovered"] == {MODEL: 1}
        st = cache.stats()
        assert st["blocks"] == blocks_before and st["hits"] >= 1
    finally:
        m._shutdown()


def test_retired_blocks_are_dropped_then_recovered_cold(monkeypatch):
    """A stored block whose memory was retired is refused at its insert
    (a fault like any other), dropped at the rebuild's revalidation, and
    the recovery prefills cold, recommits, and streams the same tokens."""
    params = _f32_params(monkeypatch)
    monkeypatch.setenv(tkv.cache_env_key(MODEL), str(64 << 20))
    m = _port_model(params)
    try:
        win = _window([4, 8, 15, 16, 23, 42])
        want = _reference_tokens(win, 5)
        first, errs = _drain(m.submit_generation(win, 5))
        assert not errs and first == want
        cache = tkv.get(MODEL)
        mgr = DeviceFaultManager(threshold=100)
        m.attach_device_faults(mgr)
        with cache._lock:
            for blk in cache._blocks.values():
                tkv.retire(blk.k)
                tkv.retire(blk.v)
        toks, errs = _drain(m.submit_generation(win, 5))
        assert not errs and toks == want
        snap = mgr.snapshot()
        assert snap["recovered"] == {MODEL: 1}
        assert snap["faults"] == {f"{MODEL}/prefill": 1}
        st = cache.stats()
        assert st["blocks"] == 1 and st["evictions"] >= 1
        again, errs = _drain(m.submit_generation(win, 5))
        assert not errs and again == want
    finally:
        m._shutdown()


# -- the wire ---------------------------------------------------------------

@pytest.fixture(scope="module")
def servers():
    jreg, treg = JaxRegistry(), ModelRegistry()
    jreg.register_model(jzoo.make_custom_identity_int32())
    treg.register_model(tzoo.make_custom_identity_int32())
    with JaxHarness(jreg) as jh, ServerHarness(treg) as th:
        yield th, jh


def _http_infer(url):
    x = np.arange(4, dtype=np.int32).reshape(1, 4)
    body = (b'{"inputs": [{"name": "INPUT0", "shape": [1, 4], '
            b'"datatype": "INT32", "data": [0, 1, 2, 3]}]}')
    req = urllib.request.Request(
        f"http://{url}/v2/models/custom_identity_int32/infer", data=body,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, None, r.read(), x
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Retry-After"), e.read(), x


def _ready(url):
    req = urllib.request.Request(
        f"http://{url}/v2/models/custom_identity_int32/ready")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def _grpc_refusal(url):
    with tgrpc.InferenceServerClient(url) as c:
        ready = c.is_model_ready("custom_identity_int32")
        inp = tgrpc.InferInput("INPUT0", [1, 4], "INT32")
        inp.set_data_from_numpy(np.arange(4, dtype=np.int32).reshape(1, 4))
        try:
            c.infer("custom_identity_int32", [inp])
            return ready, None, None
        except Exception as e:  # noqa: BLE001 - compared below
            return ready, e.status(), e.message()


def test_quarantine_refusal_on_both_frontends(servers):
    th, jh = servers
    name = "custom_identity_int32"
    out = {}
    for pkg, h in (("port", th), ("jax", jh)):
        faults = h.core.device_faults
        faults.quarantine(name, "drill")
        try:
            status, retry_after, body, _x = _http_infer(h.http_url)
            with thttp.InferenceServerClient(h.http_url) as c:
                ready_http = c.is_model_ready(name)
                with pytest.raises(Exception) as e:
                    c.infer(name, [_identity_input()])
            out[pkg] = (_ready(h.http_url), ready_http, status, body,
                        retry_after is not None, str(e.value),
                        is_quarantine_error(e.value),
                        _grpc_refusal(h.http_url))
        finally:
            faults.unquarantine(name)
        with thttp.InferenceServerClient(h.http_url) as c:
            assert c.is_model_ready(name)
            c.infer(name, [_identity_input()])
    assert out["port"] == out["jax"]
    ready, ready_http, status, body, pushback, msg, marked, grpc = \
        out["port"]
    assert ready == 400 and ready_http is False and status == 503
    assert pushback and marked and "quarantined" in msg
    assert grpc[0] is False and grpc[1] == "StatusCode.UNAVAILABLE"
    assert "quarantined" in grpc[2]


def _identity_input():
    i = thttp.InferInput("INPUT0", [1, 4], "INT32")
    i.set_data_from_numpy(np.arange(4, dtype=np.int32).reshape(1, 4))
    return i


def test_core_prober_releases_a_quarantined_model(servers):
    """The port has no fleet loop: the core's prober thread runs the due
    probes while a model is quarantined."""
    th, _jh = servers
    faults = th.core.device_faults
    calls = []
    faults.register_probe("probe_m", lambda: calls.append(1) or True)
    old = faults.probe_backoff_s
    faults.probe_backoff_s = 0.05
    try:
        faults.quarantine("probe_m", "drill")
        _poll(lambda: not faults.is_quarantined("probe_m"),
              what="the prober's release")
        assert calls
    finally:
        faults.probe_backoff_s = old


# -- the flags --------------------------------------------------------------

def test_generation_flags(monkeypatch):
    import argparse

    from triton_client_tpu_torch.server import __main__ as cli
    from triton_client_tpu_torch.server.core import InferenceCore

    for var in ("TRITON_TPU_TICK_STALL_MS", "TRITON_TPU_KV_CACHE_BYTES",
                tkv.cache_env_key("llama_decode")):
        monkeypatch.delenv(var, raising=False)
    ap = argparse.ArgumentParser()
    cli._add_generation_flags(ap)
    d = ap.parse_args([])
    assert (d.device_fault_threshold, d.device_fault_window,
            d.device_fault_probe_backoff, d.device_fault_probe_backoff_max,
            d.tick_stall_ms, d.kv_cache_bytes) == (3, 30.0, 1.0, 30.0, None,
                                                   None)
    core = InferenceCore(ModelRegistry())
    try:
        args = ap.parse_args([
            "--kv-cache-bytes", "llama_decode=268435456",
            "--kv-cache-bytes", "1024", "--device-fault-threshold", "2",
            "--device-fault-window", "5", "--device-fault-probe-backoff",
            "0.01", "--device-fault-probe-backoff-max", "0.02",
            "--tick-stall-ms", "250"])
        monkeypatch.setattr(cli.os, "environ", dict(cli.os.environ))
        cli._configure_generation(ap, args, core)
        env = cli.os.environ
        assert env[tkv.cache_env_key("llama_decode")] == "268435456"
        assert env["TRITON_TPU_KV_CACHE_BYTES"] == "1024"
        assert env["TRITON_TPU_TICK_STALL_MS"] == "250.0"
        f = core.device_faults
        assert (f.threshold, f.window_s, f.probe_backoff_s,
                f.probe_backoff_max_s) == (2, 5.0, 0.05, 0.05)
        for bad in (["--tick-stall-ms", "0"], ["--kv-cache-bytes", "m=x"],
                    ["--kv-cache-bytes", "-1"],
                    ["--device-fault-threshold", "0"],
                    ["--device-fault-window", "0"]):
            with pytest.raises(SystemExit):
                cli._configure_generation(ap, ap.parse_args(bad), core)
    finally:
        core.shutdown()
