"""The fleet in the port against the reference's, on the CPU.

The counterpart of ``tests/test_fleet.py``, class by class:

* the autoscale spec, the restart policy and the supervisor's state file:
  the same inputs give the reference's outputs (each package reads the
  other's state file);
* the batcher's live resize: growth and shrink under load, no request lost
  or doubled, the shrink debt absorbed by completions;
* the controller's decisions on stubbed signals with an injected ``now``:
  the port's and the reference's controller step for step;
* the ``worker_kill`` and ``load_fail`` kinds, drawn as the reference draws
  them;
* rolling updates (completed, rolled back, warmup failed, a stop mid-bake,
  a second update refused) with the reference's outcomes, texts and
  ``nv_fleet_*`` rows, and the flip under c = 8 wire traffic;
* the CLI supervisor (``--frontends 2 --device cpu``): a SIGKILLed worker,
  and a ``worker_kill`` draw, each mid c = 8 run under ``RetryPolicy(3)``:
  zero caller errors, one counted restart on every worker's metrics port
  (and, after the SIGKILL, in the port's ``top --once --json`` over the
  fleet's frontend), SIGTERM drains to exit 0;
* a drill on ``ClusterHarness`` and ``ReplicaSupervisor``: a seeded
  ``worker_kill`` and a rolling update under overload, flooded through the
  port's ``ClusterClient`` (least outstanding, ``RetryPolicy(3)``), as the
  reference's drill floods through its own;
* the sibling-worker shared-memory manifest;
* the ``nv_fleet_*`` rows.

Every wait polls with a deadline; the subprocess tests assert counts and
exit codes, never a time.
"""

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from triton_client_tpu.models import zoo as jzoo
from triton_client_tpu.server import InferenceCore as JaxCore
from triton_client_tpu.server import PyModel as JaxPyModel
from triton_client_tpu.server import chaos as jchaos
from triton_client_tpu.server import fleet as jfleet
from triton_client_tpu.server import make_config as jmake_config
from triton_client_tpu.server import types as jtypes
from triton_client_tpu.server.registry import ModelRegistry as JaxRegistry
from triton_client_tpu_torch import _resilience as tres
from triton_client_tpu_torch import http as thttp
from triton_client_tpu_torch.cluster import ClusterClient
from triton_client_tpu_torch.models import zoo as tzoo
from triton_client_tpu_torch.server import chaos as tchaos
from triton_client_tpu_torch.server import fleet as tfleet
from triton_client_tpu_torch.server import shm as tshm
from triton_client_tpu_torch.server import types as ttypes
from triton_client_tpu_torch.server.core import InferenceCore
from triton_client_tpu_torch.server.device_stats import SloObjective
from triton_client_tpu_torch.server.model import PyModel, make_config
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import (ClusterHarness,
                                                    ReplicaSupervisor,
                                                    ServerHarness, free_port)
from triton_client_tpu_torch.server.types import InferError
from triton_client_tpu_torch.utils import shared_memory as tsysshm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wait(cond, timeout=30.0, msg="condition", poll=0.005):
    end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > end:
            raise AssertionError(f"timed out waiting for {msg}")
        time.sleep(poll)


# -- the autoscale spec --------------------------------------------------------

class TestParseAutoscale:
    @pytest.mark.parametrize("spec", ["m=2..6", "m=..3", "m=2..", "m=..",
                                      "a.b=1..1"])
    def test_full_and_partial_bounds(self, spec):
        assert tfleet.parse_autoscale_spec(spec) == \
            jfleet.parse_autoscale_spec(spec)

    @pytest.mark.parametrize("bad", ["m", "m=", "=2..4", "m=4..2",
                                     "m=0..4", "m=a..b", "m=3"])
    def test_junk_fails_loudly(self, bad):
        texts = []
        for mod in (tfleet, jfleet):
            with pytest.raises(ValueError) as e:
                mod.parse_autoscale_spec(bad)
            texts.append(str(e.value))
        assert texts[0] == texts[1]


# -- the restart policy --------------------------------------------------------

_POLICY_CASES = [
    (dict(base_delay_s=0.5, max_delay_s=2.0, storm_limit=10,
          window_s=100.0), [0.0, 1.0, 2.0, 3.0, 4.0]),
    (dict(storm_limit=3, window_s=10.0), [0.0, 1.0, 2.0, 3.0]),
    (dict(base_delay_s=0.5, storm_limit=3, window_s=10.0),
     [0.0, 1.0, 100.0, 100.5, 130.0]),
    (dict(storm_limit=1), [0.0, 50.0]),
    (dict(), [0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 40.0]),
]


class TestRestartPolicy:
    @pytest.mark.parametrize("kw,times", _POLICY_CASES,
                             ids=["doubles-caps", "storm", "aging",
                                  "limit-one", "defaults"])
    def test_delays_equal_reference(self, kw, times):
        t, j = tfleet.RestartPolicy(**kw), jfleet.RestartPolicy(**kw)
        assert [t.on_crash(now=x) for x in times] == \
            [j.on_crash(now=x) for x in times]
        assert t.recent_crashes(now=times[-1]) == \
            j.recent_crashes(now=times[-1])

    def test_backoff_doubles_and_caps(self):
        p = tfleet.RestartPolicy(base_delay_s=0.5, max_delay_s=2.0,
                                 storm_limit=10, window_s=100.0)
        assert [p.on_crash(now=float(i)) for i in range(5)] == \
            [0.5, 1.0, 2.0, 2.0, 2.0]

    def test_storm_limit_validated(self):
        for mod in (tfleet, jfleet):
            with pytest.raises(ValueError):
                mod.RestartPolicy(storm_limit=0)


# -- the supervisor's state file -------------------------------------------------

class TestSupervisorState:
    def test_round_trip_across_packages(self, tmp_path, monkeypatch):
        path = str(tmp_path / "fleet-state.json")
        state = tfleet.SupervisorState(path)
        assert tfleet.worker_restart_counts(path) == {}
        assert state.record_restart("0") == 1
        assert state.record_restart("0", reason="signal:SIGKILL") == 2
        assert state.record_restart("1", reason="chaos:worker_kill") == 1
        for mod in (tfleet, jfleet):
            assert mod.worker_restart_counts(path) == {"0": 2, "1": 1}
            assert mod.worker_crash_reasons(path) == {
                "0": "signal:SIGKILL", "1": "chaos:worker_kill"}
        # the reference's file reads the same in the port
        jpath = str(tmp_path / "ref-state.json")
        jfleet.SupervisorState(jpath).record_restart("3", reason="exit:2")
        assert tfleet.worker_restart_counts(jpath) == {"3": 1}
        assert tfleet.worker_crash_reasons(jpath) == {"3": "exit:2"}
        monkeypatch.setenv(tfleet.FLEET_STATE_ENV, path)
        assert tfleet.worker_restart_counts() == {"0": 2, "1": 1}
        assert tfleet.fleet_state_path() == path
        monkeypatch.delenv(tfleet.FLEET_STATE_ENV)
        assert tfleet.worker_restart_counts() == {}

    def test_cache_tracks_file_changes(self, tmp_path):
        path = str(tmp_path / "fleet-state.json")
        state = tfleet.SupervisorState(path)
        state.record_restart("2")
        assert tfleet.worker_restart_counts(path) == {"2": 1}
        time.sleep(0.01)
        state.record_restart("2")
        assert tfleet.worker_restart_counts(path)["2"] == 2

    def test_junk_file_reads_empty(self, tmp_path):
        path = str(tmp_path / "junk.json")
        with open(path, "w") as f:
            f.write("{not json")
        assert tfleet.worker_restart_counts(path) == \
            jfleet.worker_restart_counts(path) == {}

    @pytest.mark.parametrize("code", [None, -9, -15, -200, 0, 1, 70, 143])
    def test_crash_reason_equal_reference(self, code):
        assert tfleet.crash_reason_from_exit(code) == \
            jfleet.crash_reason_from_exit(code)


# -- the batcher's resize --------------------------------------------------------

def _blocking_batch_model(name, gate, started, lock, done=None):
    """max_batch_size 1, dynamic batching: each execution blocks on
    ``gate``; ``started`` counts the executions that began."""
    cfg = make_config(name, inputs=[("IN", "INT32", [-1])],
                      outputs=[("OUT", "INT32", [-1])], max_batch_size=1,
                      preferred_batch_sizes=[1])

    def fn(inputs, params):
        with lock:
            started[0] += 1
        gate.wait(timeout=30)
        if done is not None:
            with lock:
                done[0] += 1
        return {"OUT": inputs["IN"]}

    return PyModel(cfg, fn)


def _req(model, n=1, input_name="IN", value=1, types=ttypes):
    return types.InferRequest(
        model_name=model,
        inputs=[types.InputTensor(input_name, "INT32", (1, n),
                                  data=np.full((1, n), value, np.int32))])


def _in_threads(fn, args_list):
    """Run ``fn(*args)`` for each of ``args_list`` on threads of their own;
    returns (threads, results, errors)."""
    results, errors = [None] * len(args_list), []

    def run(i, args):
        try:
            results[i] = fn(*args)
        except Exception as e:  # noqa: BLE001 - reported by the caller
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, a), daemon=True)
               for i, a in enumerate(args_list)]
    for t in threads:
        t.start()
    return threads, results, errors


class TestBatcherInstances:
    def test_set_instances_resizes_live_concurrency(self):
        gate, started, lock = threading.Event(), [0], threading.Lock()
        registry = ModelRegistry()
        registry.register_model(
            _blocking_batch_model("scaly", gate, started, lock))
        core = InferenceCore(registry)
        ctl = tfleet.FleetController(core, bounds={"scaly": (1, 8)})
        core.fleet = ctl
        try:
            ctl.scale_to("scaly", 2)
            threads, results, errors = _in_threads(
                core.infer, [(_req("scaly", value=i),) for i in range(6)])
            _wait(lambda: started[0] == 2, msg="2 started")
            time.sleep(0.1)
            assert started[0] == 2
            b = core._batchers["scaly@1"]
            assert b.instances == 2
            # out: the live batcher at once
            ctl.scale_to("scaly", 4, direction="out")
            _wait(lambda: started[0] == 4, msg="4 started")
            assert b.instances == 4
            # in: no running batch interrupted, nothing queued dropped
            ctl.scale_to("scaly", 1, direction="in")
            assert b._shrink_debt == 3
            gate.set()
            for t in threads:
                t.join(timeout=30)
            assert not errors and len([r for r in results if r]) == 6
            assert sorted(int(r.outputs[0].data[0, 0]) for r in results) \
                == list(range(6))
            # the debt settled as the batches finished: one at a time now
            _wait(lambda: b._running == 0, msg="the batches to end")
            assert b._shrink_debt == 0
            gate.clear()
            started[0] = 0
            threads, _, errors = _in_threads(
                core.infer, [(_req("scaly"),) for _ in range(3)])
            _wait(lambda: started[0] == 1, msg="1 started")
            time.sleep(0.1)
            assert started[0] == 1
            gate.set()
            for t in threads:
                t.join(timeout=30)
            assert not errors
            assert ctl.scale_events == {("scaly", "out"): 1,
                                        ("scaly", "in"): 1}
        finally:
            gate.set()
            core.shutdown()

    def test_new_batcher_inherits_scaled_target(self):
        gate = threading.Event()
        gate.set()
        registry = ModelRegistry()
        registry.register_model(_blocking_batch_model(
            "scaly", gate, [0], threading.Lock()))
        core = InferenceCore(registry)
        ctl = tfleet.FleetController(core, bounds={"scaly": (1, 8)})
        core.fleet = ctl
        ctl.scale_to("scaly", 6)
        try:
            core.infer(_req("scaly"))
            b = core._batchers["scaly@1"]
            # the permit comes back just after the answer
            _wait(lambda: b._running == 0, msg="the batch to end")
            assert b.instances == 6 and b._permits == 6
        finally:
            core.shutdown()

    @pytest.mark.parametrize("sizes", [(1, 8, 2, 6, 1, 3), (8, 1, 8, 1)],
                             ids=["mixed", "swing"])
    def test_grow_and_shrink_under_load(self, sizes):
        """48 requests at c = 12 while the instances swing: every request
        answered once with its own value, never more executing than the
        largest target, and the permits whole at the end."""
        gate, started, lock = threading.Event(), [0], threading.Lock()
        gate.set()
        done = [0]
        live, peak = [0], [0]
        cfg = make_config("swing", inputs=[("IN", "INT32", [-1])],
                          outputs=[("OUT", "INT32", [-1])], max_batch_size=1,
                          preferred_batch_sizes=[1])

        def fn(inputs, params):
            with lock:
                live[0] += 1
                peak[0] = max(peak[0], live[0])
            time.sleep(0.004)
            with lock:
                live[0] -= 1
                done[0] += 1
            return {"OUT": inputs["IN"]}

        registry = ModelRegistry()
        registry.register_model(PyModel(cfg, fn))
        core = InferenceCore(registry)
        ctl = tfleet.FleetController(core, bounds={"swing": (1, 8)})
        core.fleet = ctl
        ctl.scale_to("swing", sizes[0])
        try:
            results, errors = {}, []

            def client(c):
                try:
                    for k in range(4):
                        v = c * 100 + k
                        r = core.infer(_req("swing", value=v))
                        results.setdefault(v, []).append(
                            int(r.outputs[0].data[0, 0]))
                except Exception as e:  # noqa: BLE001 - reported below
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(c,),
                                        daemon=True) for c in range(12)]
            for t in threads:
                t.start()
            for n in sizes[1:]:
                time.sleep(0.02)
                ctl.scale_to("swing", n)
            for t in threads:
                t.join(timeout=60)
            assert not errors, errors
            assert results == {c * 100 + k: [c * 100 + k]
                               for c in range(12) for k in range(4)}
            assert done[0] == 48 and peak[0] <= max(sizes)
            b = core._batchers["swing@1"]
            _wait(lambda: b._running == 0, msg="the batches to end")
            assert b._shrink_debt == 0
            assert b._permits == b.instances == sizes[-1]
        finally:
            core.shutdown()


# -- the controller's decisions ----------------------------------------------------

MODEL = "custom_identity_int32"


def _controllers(**kw):
    """The port's and the reference's controller over a core with
    custom_identity_int32, their signals stubbed (replaced per step)."""
    out = []
    for zoo, registry_cls, core_cls, mod in (
            (tzoo, ModelRegistry, InferenceCore, tfleet),
            (jzoo, JaxRegistry, JaxCore, jfleet)):
        registry = registry_cls()
        registry.register_model(zoo.make_custom_identity_int32())
        core = core_cls(registry)
        args = dict(kw)
        args.setdefault("bounds", {MODEL: (1, 6)})
        args.setdefault("scale_out_cooldown_s", 1.0)
        args.setdefault("scale_in_cooldown_s", 2.0)
        args.setdefault("idle_cycles", 3)
        ctl = mod.FleetController(core, **args)
        core.fleet = ctl
        out.append(ctl)
    return out


def _step(ctls, now, burn=None, duty=None, depth=0):
    for ctl in ctls:
        ctl.burn = lambda name, now=None, b=burn: b
        ctl.duty = lambda name, now=None, d=duty: d
        ctl.queue_depth = lambda name, q=depth: q
        ctl.evaluate(now=now)
    return [ctl.desired_instances(MODEL) for ctl in ctls]


# (controller kwargs, [(now, burn, duty, depth), ...])
_SCHEDULES = {
    "burn-out-cooldown": ({}, [(100.0, 20.0, None, 0), (100.5, 20.0, None, 0),
                               (101.5, 20.0, None, 0),
                               (103.0, 20.0, None, 0)]),
    "backlog-out": ({"queue_high": 2.0}, [(10.0, None, None, 100),
                                          (10.5, None, None, 100),
                                          (12.0, None, None, 100)]),
    "dead-band": ({"queue_high": 4.0},
                  [(float(t * 10), None, 0.5, 10) for t in range(20)]),
    "idle-in": ({"idle_cycles": 3},
                [(t, None, 0.0, 0) for t in (10.0, 11.0, 12.0, 12.5, 15.0,
                                             18.0, 21.0)]
                + [(30.0 + 3 * t, None, 0.0, 0) for t in range(10)]),
    "pressure-resets-streak": (
        {"idle_cycles": 2, "scale_out_cooldown_s": 100.0},
        [(10.0, None, 0.0, 0), (11.0, 20.0, 0.0, 0), (12.0, None, 0.0, 0),
         (13.0, None, 0.0, 0)]),
    "noise": ({"idle_cycles": 2, "queue_high": 3.0},
              [(float(t), b, d, q) for t, (b, d, q) in enumerate(
                  [(None, 0.0, 0), (15.0, 0.2, 2), (None, 0.01, 0),
                   (None, 0.01, 0), (None, 0.01, 0), (1.0, 0.5, 30),
                   (None, 0.0, 0), (None, 0.0, 0), (None, 0.0, 0),
                   (None, 0.0, 0), (None, 0.9, 0), (30.0, 0.9, 0)] * 3)]),
}


class TestAutoscalerPolicy:
    @pytest.mark.parametrize("case", sorted(_SCHEDULES))
    def test_decisions_equal_reference_step_for_step(self, case):
        kw, schedule = _SCHEDULES[case]
        ctls = _controllers(**kw)
        for now, burn, duty, depth in schedule:
            port, ref = _step(ctls, now, burn, duty, depth)
            assert port == ref, (case, now)
            assert ctls[0]._idle_streak == ctls[1]._idle_streak, (case, now)
        assert ctls[0].scale_events == ctls[1].scale_events

    def test_burn_breach_scales_out_with_cooldown(self):
        ctls = _controllers()
        assert _step(ctls, 100.0, burn=20.0) == [5, 5]
        assert _step(ctls, 100.5, burn=20.0) == [5, 5]
        assert _step(ctls, 101.5, burn=20.0) == [6, 6]
        assert _step(ctls, 103.0, burn=20.0) == [6, 6]
        assert ctls[0].scale_events[(MODEL, "out")] == 2

    def test_config_parameter_bounds(self):
        registry = ModelRegistry()
        m = tzoo.make_custom_identity_int32()
        m.config.parameters["autoscale.min_instances"] = "2"
        m.config.parameters["autoscale.max_instances"] = "3"
        registry.register_model(m)
        jregistry = JaxRegistry()
        jm = jzoo.make_custom_identity_int32()
        jm.config.parameters["autoscale.min_instances"].string_value = "2"
        jm.config.parameters["autoscale.max_instances"].string_value = "3"
        jregistry.register_model(jm)
        ctl = tfleet.FleetController(InferenceCore(registry))
        jctl = jfleet.FleetController(JaxCore(jregistry))
        assert ctl.bounds_for(MODEL) == jctl.bounds_for(MODEL) == (2, 3)
        assert ctl.desired_instances(MODEL) == \
            jctl.desired_instances(MODEL) == 3
        ctl.bounds[MODEL] = (1, 6)
        assert ctl.bounds_for(MODEL) == (1, 6)

    @pytest.mark.parametrize("lo,hi", [("0", "3"), ("4", "2"), ("x", None),
                                       (None, "5"), ("2", None)])
    def test_config_bounds_junk_equal_reference(self, lo, hi):
        registry, jregistry = ModelRegistry(), JaxRegistry()
        m, jm = tzoo.make_custom_identity_int32(), \
            jzoo.make_custom_identity_int32()
        for key, value in (("autoscale.min_instances", lo),
                           ("autoscale.max_instances", hi)):
            if value is not None:
                m.config.parameters[key] = value
                jm.config.parameters[key].string_value = value
        registry.register_model(m)
        jregistry.register_model(jm)
        assert tfleet.FleetController(InferenceCore(registry)).bounds_for(
            MODEL) == jfleet.FleetController(JaxCore(jregistry)).bounds_for(
            MODEL)

    def test_unbounded_model_untouched(self):
        ctls = _controllers(bounds={})
        assert _step(ctls, 10.0, burn=100.0, depth=1000) == [None, None]
        assert ctls[0].scale_events == {} == ctls[1].scale_events

    def test_quarantine_holds_target(self):
        ctls = _controllers()
        for ctl in ctls:
            ctl._core.device_faults.quarantine(MODEL, "test")
        assert _step(ctls, 10.0, burn=None, duty=0.0) == [4, 4]
        assert _step(ctls, 11.0, burn=50.0, depth=100) == [4, 4]
        assert ctls[0].scale_events == {} == ctls[1].scale_events

    def test_running_loop_drives_probes(self):
        """With the loop's thread running, quarantine probes run from
        evaluate; the core's prober stands aside."""
        registry = ModelRegistry()
        registry.register_model(tzoo.make_custom_identity_int32())
        core = InferenceCore(registry)
        faults = core.device_faults
        faults.probe_backoff_s = 0.0
        probes = []
        faults.register_probe(MODEL, lambda: probes.append(1) or True)
        ctl = tfleet.FleetController(core, interval_s=0.02)
        core.fleet = ctl
        ctl.start()
        try:
            assert ctl.running
            faults.quarantine(MODEL, "test")
            _wait(lambda: not faults.is_quarantined(MODEL), timeout=10,
                  msg="the probe's release")
            assert probes
        finally:
            core.shutdown()
        assert not ctl.running


# -- chaos: the fleet's kinds ------------------------------------------------------

class TestChaosFleetKinds:
    def test_worker_kill_is_data_plane_and_deterministic(self):
        seqs = []
        for mod in (tchaos, jchaos):
            inj = mod.ChaosInjector(rate=0.5, kinds=["worker_kill", "error"],
                                    seed=7)
            seqs.append([getattr(inj.decide("m"), "kind", None)
                         for _ in range(50)])
        assert seqs[0] == seqs[1] and "worker_kill" in seqs[0]

    def test_load_fail_never_fires_per_request(self):
        inj = tchaos.ChaosInjector(rate=1.0, kinds=["load_fail"], seed=3)
        assert all(inj.decide("m") is None for _ in range(20))
        with pytest.raises(InferError, match="injected load failure"):
            inj.maybe_fail_load("m")
        assert inj.injected_by_model == {"m": 1}

    def test_worker_kill_fires_callback_and_stamps_flight_record(self):
        registry = ModelRegistry()
        registry.register_model(tzoo.make_custom_identity_int32())
        core = InferenceCore(registry)
        core.chaos = tchaos.ChaosInjector(rate=1.0, kinds=["worker_kill"],
                                          seed=1, max_faults=1)
        killed = []
        core.chaos.worker_kill_cb = lambda: killed.append(True)
        with pytest.raises(tchaos.ChaosAbort) as ei:
            core.infer(_req(MODEL, 4, input_name="INPUT0"))
        assert ei.value.http_status == 503
        assert str(ei.value) == "chaos: injected worker kill"
        assert killed == [True]
        rec = core.flight_recorder.snapshot(model=MODEL)["recent"][-1]
        assert rec["chaos"] == "worker_kill"
        # the budget is spent: the next request is served
        resp = core.infer(_req(MODEL, 4, input_name="INPUT0"))
        assert resp.outputs[0].data is not None
        core.shutdown()

    def test_worker_kill_text_equal_reference(self):
        texts = []
        for zoo, registry_cls, core_cls, mod, types in (
                (tzoo, ModelRegistry, InferenceCore, tchaos, ttypes),
                (jzoo, JaxRegistry, JaxCore, jchaos, jtypes)):
            registry = registry_cls()
            registry.register_model(zoo.make_custom_identity_int32())
            core = core_cls(registry)
            core.chaos = mod.ChaosInjector(rate=1.0, kinds=["worker_kill"],
                                           seed=1, max_faults=1)
            req = _req(MODEL, 4, input_name="INPUT0", types=types)
            try:
                out = core.infer(req)
                if asyncio.iscoroutine(out):
                    asyncio.run(out)
            except Exception as e:  # noqa: BLE001 - compared below
                texts.append((type(e).__name__, str(e),
                              getattr(e, "http_status", None)))
        assert texts[0] == texts[1]

    def test_load_fail_injected_into_core_load(self):
        registry = ModelRegistry()
        registry.register_model(tzoo.make_custom_identity_int32())
        core = InferenceCore(registry)
        core.chaos = tchaos.ChaosInjector(rate=1.0, kinds=["load_fail"],
                                          seed=1, max_faults=1)
        with pytest.raises(InferError, match="injected load failure"):
            core.load_model(MODEL)
        core.load_model(MODEL)
        resp = core.infer(_req(MODEL, 4, input_name="INPUT0"))
        assert resp.outputs[0].data is not None
        core.shutdown()


# -- rolling updates -------------------------------------------------------------

VER = "verid"


def _versioned_identity(name, tag, fail=False, warmup=False,
                        make=make_config, model_cls=PyModel, delay_s=0.0):
    """Identity plus ``tag``: each answer says which version gave it;
    ``fail`` builds the bad version."""
    kw = {}
    if warmup:
        kw["warmup"] = [{"name": "w", "batch_size": 1,
                         "inputs": {"IN": ("INT32", [4], "zero")}}]
    cfg = make(name, inputs=[("IN", "INT32", [-1])],
               outputs=[("OUT", "INT32", [-1])], max_batch_size=8,
               preferred_batch_sizes=[4], max_queue_delay_us=200, **kw)

    def fn(inputs, params):
        if fail:
            raise RuntimeError("bad version")
        if delay_s:
            time.sleep(delay_s)
        return {"OUT": np.asarray(inputs["IN"]) + np.int32(tag)}

    return model_cls(cfg, fn)


def _port_core(**kw):
    registry = ModelRegistry()
    registry.register_model(_versioned_identity(VER, 0))
    core = InferenceCore(registry)
    ctl = tfleet.FleetController(core, bake_s=0.2, bake_min_samples=4, **kw)
    core.fleet = ctl
    return core, ctl


def _run_update(ctl, model, **kw):
    """A rolling update on a thread of its own: (thread, box) where box
    gets "result" or "error"."""
    box = {}

    def run():
        try:
            box["result"] = ctl.rolling_update(VER, model, **kw)
        except Exception as e:  # noqa: BLE001 - read by the caller
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


def _reference_update(scenario: str):
    """One scenario on the reference: (outcome or error text,
    update_events, fleet rows)."""
    registry = JaxRegistry()
    registry.register_model(_versioned_identity(
        VER, 0, make=jmake_config, model_cls=JaxPyModel))
    core = JaxCore(registry)
    ctl = jfleet.FleetController(core, bake_s=0.2, bake_min_samples=4)
    core.fleet = ctl

    async def main():
        await core.infer(_req(VER, 4, types=jtypes))
        if scenario == "completed":
            out = await ctl.rolling_update(VER, _versioned_identity(
                VER, 100, warmup=True, make=jmake_config,
                model_cls=JaxPyModel), bake_s=0.1)
        elif scenario == "warmup_failed":
            try:
                await ctl.rolling_update(VER, _versioned_identity(
                    VER, 100, fail=True, warmup=True, make=jmake_config,
                    model_cls=JaxPyModel))
                out = "no error"
            except Exception as e:  # noqa: BLE001 - compared
                out = (str(e), getattr(e, "http_status", None))
        else:
            update = asyncio.create_task(ctl.rolling_update(
                VER, _versioned_identity(VER, 100, fail=True,
                                         make=jmake_config,
                                         model_cls=JaxPyModel), bake_s=5.0))
            while not update.done():
                try:
                    await core.infer(_req(VER, 4, types=jtypes))
                except Exception:  # noqa: BLE001 - the bad version fails
                    pass
                await asyncio.sleep(0.01)
            out = await update
        served = core.registry.get(VER).served_version
        versions = core.registry.get(VER).versions
        await core.shutdown(drain_s=0.2)
        return out, served, versions

    out, served, versions = asyncio.run(main())
    return (out, served, versions, dict(ctl.update_events),
            jfleet.collect_fleet_rows(core))


def _port_update(scenario: str):
    core, ctl = _port_core()
    try:
        core.infer(_req(VER, 4))
        if scenario == "completed":
            out = ctl.rolling_update(VER, _versioned_identity(
                VER, 100, warmup=True), bake_s=0.1)
        elif scenario == "warmup_failed":
            try:
                ctl.rolling_update(VER, _versioned_identity(
                    VER, 100, fail=True, warmup=True))
                out = "no error"
            except Exception as e:  # noqa: BLE001 - compared
                out = (str(e), getattr(e, "http_status", None))
        else:
            t, box = _run_update(ctl, _versioned_identity(VER, 100,
                                                          fail=True),
                                 bake_s=5.0)
            while t.is_alive():
                try:
                    core.infer(_req(VER, 4))
                except Exception:  # noqa: BLE001 - the bad version fails
                    pass
                time.sleep(0.01)
            out = box.get("result", box.get("error"))
        served = core.registry.get(VER).served_version
        versions = core.registry.get(VER).versions
        rows = tfleet.collect_fleet_rows(core)
    finally:
        core.shutdown()
    return out, served, versions, dict(ctl.update_events), rows


class TestRollingUpdate:
    @pytest.mark.parametrize("scenario", ["completed", "warmup_failed",
                                          "rolled_back"])
    def test_outcome_texts_and_rows_equal_reference(self, scenario):
        port = _port_update(scenario)
        ref = _reference_update(scenario)
        assert port[:4] == ref[:4]
        for key in ("serving_version", "scale", "rolling_update",
                    "worker_restart"):
            assert port[4][key] == ref[4][key], key

    def test_staged_version_invisible_and_not_ready(self):
        core, ctl = _port_core()
        registry = core.registry
        registry.stage_version(VER, _versioned_identity(VER, 100), "2")
        assert not registry.is_ready(VER, "2")
        assert registry.get(VER).served_version == "1"
        assert registry.get(VER).versions == ["1"]
        assert all(e["version"] != "2" for e in registry.index())
        assert not registry.any_loading()
        with pytest.raises(InferError):
            registry.get(VER, "2")
        with pytest.raises(InferError):
            registry.stage_version(VER, _versioned_identity(VER, 1), "2")
        with pytest.raises(InferError):
            registry.stage_version(VER, _versioned_identity(VER, 1), "1")
        # the generation does not move: the core tells instances apart
        gen = registry.generation(VER)
        registry.promote(VER, "2")
        assert registry.generation(VER) == gen
        with pytest.raises(InferError, match="only served version"):
            _single().demote("m", "1")
        core.shutdown()

    def test_completed_update_flips_and_keeps_old_addressable(self):
        core, ctl = _port_core()
        try:
            r = core.infer(_req(VER, 4))
            np.testing.assert_array_equal(r.outputs[0].data,
                                          np.ones((1, 4), np.int32))
            old_thread = core._batchers[f"{VER}@1"]._thread
            assert ctl.rolling_update(VER, _versioned_identity(
                VER, 100, warmup=True), bake_s=0.1) == "completed"
            # the old default's batcher was drained and stopped
            assert f"{VER}@1" not in core._batchers
            assert not old_thread.is_alive()
            r2 = core.infer(_req(VER, 4))
            np.testing.assert_array_equal(r2.outputs[0].data,
                                          np.ones((1, 4), np.int32) + 100)
            req_v1 = _req(VER, 4)
            req_v1.model_version = "1"
            r1 = core.infer(req_v1)
            np.testing.assert_array_equal(r1.outputs[0].data,
                                          np.ones((1, 4), np.int32))
            assert core.registry.get(VER).versions == ["1", "2"]
            # the warmup stayed out of v2's statistics
            v2 = core.registry.get(VER, "2")
            assert v2.stats.success_count == 1
        finally:
            core.shutdown()

    def test_warmup_failure_unloads_staged_instance(self):
        core, ctl = _port_core()
        bad = _versioned_identity(VER, 100, fail=True, warmup=True)
        unloaded = []
        bad.unload = lambda: unloaded.append(True)
        with pytest.raises(InferError, match="warmup"):
            ctl.rolling_update(VER, bad)
        assert unloaded == [True]
        assert core.registry.staged_version(VER, "2") is None
        core.shutdown()

    def test_slo_breach_during_bake_rolls_back(self):
        registry = ModelRegistry()
        registry.register_model(_versioned_identity(VER, 0))
        core = InferenceCore(registry)
        core.slo.set_objective(VER, SloObjective(p99_ms=5.0,
                                                 availability=0.95))
        ctl = tfleet.FleetController(core, bake_s=5.0)
        core.fleet = ctl
        try:
            t, box = _run_update(ctl, _versioned_identity(
                VER, 100, delay_s=0.05), bake_s=5.0)
            end = time.monotonic() + 20
            while t.is_alive():
                assert time.monotonic() < end, "no rollback"
                try:
                    core.infer(_req(VER, 4))
                except InferError:
                    pass
            assert box == {"result": "rolled_back"}
            assert core.registry.get(VER).served_version == "1"
        finally:
            core.shutdown()

    def test_stop_ends_in_flight_bake(self):
        """A stop mid-bake ends the update without an outcome; the flip
        stays."""
        core, ctl = _port_core()
        t, box = _run_update(ctl, _versioned_identity(VER, 100),
                             bake_s=60.0)
        _wait(lambda: core.registry.get(VER).served_version == "2",
              timeout=10, msg="the flip")
        core.shutdown()
        t.join(timeout=10)
        assert not t.is_alive()
        assert "ended: the fleet controller stopped" in str(box["error"])
        assert ctl.update_events == {}
        assert VER not in ctl._updating

    def test_concurrent_update_refused(self):
        core, ctl = _port_core()
        gate = threading.Event()
        core._warmup_one = lambda model: gate.wait(30) and 0
        try:
            t, box = _run_update(ctl, _versioned_identity(VER, 100),
                                 bake_s=0.0)
            _wait(lambda: VER in ctl._updating, msg="the first update")
            with pytest.raises(InferError) as ei:
                ctl.rolling_update(VER, _versioned_identity(VER, 200))
            assert ei.value.http_status == 409
            gate.set()
            t.join(timeout=10)
            assert box == {"result": "completed"}
        finally:
            gate.set()
            core.shutdown()

    def test_request_parked_across_the_flip(self):
        """A request that resolved v1 before the flip and reaches the
        batcher after the drain runs on v1 (still served), never on a
        stopped batcher."""
        core, ctl = _port_core()
        try:
            core.infer(_req(VER, 4))
            v1 = core.registry.get(VER)
            assert ctl.rolling_update(VER, _versioned_identity(VER, 100),
                                      bake_s=0.0) == "completed"
            out = core._submit(v1, {"IN": np.ones((1, 4), np.int32)}, {})
            np.testing.assert_array_equal(out["OUT"],
                                          np.ones((1, 4), np.int32))
        finally:
            core.shutdown()


def _single():
    registry = ModelRegistry()
    registry.register_model(_versioned_identity("m", 0))
    return registry


class TestRollingUpdateLiveTraffic:
    def test_atomic_flip_under_c8_zero_errors(self):
        registry = ModelRegistry()
        registry.register_model(_versioned_identity(VER, 0))
        with ServerHarness(registry) as h:
            ctl = tfleet.FleetController(h.core, bake_s=0.2,
                                         bake_min_samples=4)
            h.core.fleet = ctl
            x = np.arange(4, dtype=np.int32).reshape(1, 4)
            errors, tags = [], []
            stop = threading.Event()
            flipped = []

            def worker():
                try:
                    with thttp.InferenceServerClient(h.http_url) as c:
                        i0 = thttp.InferInput("IN", [1, 4], "INT32")
                        i0.set_data_from_numpy(x)
                        while not stop.is_set():
                            sent_after = bool(flipped)
                            out = c.infer(VER, [i0]).as_numpy("OUT")
                            tag = int(out[0, 0] - x[0, 0])
                            if tag not in (0, 100) or not np.array_equal(
                                    out, x + tag):
                                raise AssertionError(f"answer {out}")
                            if sent_after and tag != 100:
                                raise AssertionError(
                                    "v1 answered a request sent after the "
                                    "flip")
                            tags.append(tag)
                except Exception as e:  # noqa: BLE001 - reported below
                    errors.append(repr(e))

            threads = [threading.Thread(target=worker, daemon=True)
                       for _ in range(8)]
            for t in threads:
                t.start()
            _wait(lambda: len(tags) >= 40, msg="v1 traffic")
            assert ctl.rolling_update(VER, _versioned_identity(
                VER, 100, warmup=True), bake_s=0.3) == "completed"
            n_flip = len(tags)
            _wait(lambda: len(tags) >= n_flip + 40, msg="v2 traffic")
            stop.set()
            for t in threads:
                t.join(timeout=20)
            assert not errors, errors
            assert set(tags) == {0, 100}
            assert tags[-8:] == [100] * 8


# -- the CLI supervisor ----------------------------------------------------------

def _two_free_ports():
    """A port P such that P and P + 1 are free (worker i serves its metrics
    on P + i)."""
    for _ in range(50):
        p = free_port()
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", p + 1))
            return p
        except OSError:
            continue
    raise RuntimeError("no two adjacent free ports")


def _metric(port, name):
    """The sum of a family's samples on a metrics port (None when it does
    not answer)."""
    try:
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=5).read().decode()
    except OSError:
        return None
    return sum(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
               if ln.startswith(name + "{") or ln.startswith(name + " "))


class _Fleet:
    """``python -m triton_client_tpu_torch.server --frontends 2 --device
    cpu`` in a process of its own, its output read on a thread; killed in
    ``close`` whatever happened."""

    N = 2

    def __init__(self, *extra):
        self.http_port = free_port()
        self.metrics_port = _two_free_ports()
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("TRITON_TPU_")}
        env["PYTHONPATH"] = REPO
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "triton_client_tpu_torch.server",
             "--device", "cpu", "--http-port", str(self.http_port),
             "--metrics-port", str(self.metrics_port),
             "--frontends", str(self.N), "--worker-restart-window", "8",
             "--drain-timeout", "3", *extra],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self.lines, self.pids = [], {}
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line)
            if line.startswith("frontend worker ") and ": pid " in line:
                parts = line.split()
                self.pids[int(parts[2].rstrip(":"))] = int(parts[-1])

    def tail(self, n=30) -> str:
        return "".join(self.lines[-n:])

    def wait_workers(self, timeout=120.0):
        """Every worker's own metrics port answers."""
        _wait(lambda: all(_metric(self.metrics_port + i, "nv_inference_count")
                          is not None for i in range(self.N))
              and len(self.pids) >= self.N, timeout=timeout, poll=0.2,
              msg="the workers: " + self.tail())

    def restarts(self):
        """nv_fleet_worker_restart_total on each worker's port."""
        return [_metric(self.metrics_port + i,
                        "nv_fleet_worker_restart_total")
                for i in range(self.N)]

    def close(self) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)
        for pid in self.pids.values():
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
        return self.proc.returncode


def _c8_traffic(port, stop, errors, counts):
    """Eight threads sending ``simple`` under RetryPolicy(3), each answer
    checked."""
    x = np.arange(16, dtype=np.int32).reshape(1, 16)
    y = np.ones((1, 16), dtype=np.int32)
    policy = tres.RetryPolicy(max_attempts=3, retry_infer=True,
                              initial_backoff_s=0.02, seed=5)

    def worker(idx):
        try:
            with thttp.InferenceServerClient(f"127.0.0.1:{port}") as c:
                i0 = thttp.InferInput("INPUT0", [1, 16], "INT32")
                i0.set_data_from_numpy(x)
                i1 = thttp.InferInput("INPUT1", [1, 16], "INT32")
                i1.set_data_from_numpy(y)
                while not stop.is_set():
                    r = c.infer("simple", [i0, i1], retry_policy=policy)
                    np.testing.assert_array_equal(r.as_numpy("OUTPUT0"),
                                                  x + y)
                    counts[idx] += 1
        except Exception as e:  # noqa: BLE001 - reported by the test
            errors.append(f"worker {idx}: {e!r}")

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(8)]
    for t in threads:
        t.start()
    return threads


class TestSupervisorSelfHealing:
    def _drill(self, fleet, kill):
        fleet.wait_workers()
        stop, errors, counts = threading.Event(), [], [0] * 8
        threads = _c8_traffic(fleet.http_port, stop, errors, counts)
        try:
            _wait(lambda: min(counts) > 0, timeout=60, msg="traffic")
            kill()
            # the sibling serves while the victim comes back
            _wait(lambda: fleet.restarts() == [1.0, 1.0], timeout=90,
                  poll=0.2, msg="one restart on both workers: "
                  + fleet.tail())
            before = sum(counts)
            _wait(lambda: sum(counts) > before + 40, timeout=60,
                  msg="traffic after the restart")
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60)
        assert not errors, errors
        assert fleet.proc.poll() is None, fleet.tail()
        assert all(c > 0 for c in counts)

    def test_worker_kill_mid_c8_run_zero_caller_errors(self, capsys):
        """SIGKILL of one worker mid-run: zero caller errors, one counted
        restart on every worker's metrics port and in the port's ``top``
        over the fleet's frontend, SIGTERM drains to 0."""
        from triton_client_tpu_torch.tools import top

        fleet = _Fleet()
        try:
            self._drill(fleet, lambda: os.kill(fleet.pids[0],
                                               signal.SIGKILL))
            assert "(signal:SIGKILL)" in "".join(fleet.lines)
            capsys.readouterr()
            assert top.main(["--url", f"127.0.0.1:{fleet.http_port}",
                             "--once", "--json"]) == 0
            snap = json.loads(capsys.readouterr().out)
            # the worker that answered the poll reads the fleet's counter
            assert snap["worker_restarts"] == 1
        finally:
            rc = fleet.close()
        assert rc == 0, fleet.tail()

    def test_chaos_worker_kill_heals(self):
        """A worker_kill draw (one request to the chaos model, sent
        without retries) exits its worker with code 70 while c = 8 runs
        on ``simple``: zero caller errors, one restart."""
        fleet = _Fleet("--chaos", "1.0", "--chaos-kinds", "worker_kill",
                       "--chaos-model", MODEL)
        try:
            def kill():
                with thttp.InferenceServerClient(
                        f"127.0.0.1:{fleet.http_port}") as c:
                    i0 = thttp.InferInput("INPUT0", [1, 4], "INT32")
                    i0.set_data_from_numpy(np.ones((1, 4), np.int32))
                    with pytest.raises(Exception):
                        c.infer(MODEL, [i0])

            self._drill(fleet, kill)
            assert "rc=70 (chaos:worker_kill)" in "".join(fleet.lines)
        finally:
            rc = fleet.close()
        assert rc == 0, fleet.tail()


# -- a drill on the cluster harness -------------------------------------------------

DRILL = "scaly"
SERVICE_S = 0.03


def _drill_model():
    cfg = make_config(DRILL, inputs=[("IN", "INT32", [-1])],
                      outputs=[("OUT", "INT32", [-1])], max_batch_size=1,
                      preferred_batch_sizes=[1])

    def fn(inputs, params):
        time.sleep(SERVICE_S)
        return {"OUT": inputs["IN"]}

    return PyModel(cfg, fn)


class TestFleetDrill:
    """Two replicas at ~2x overload, 8 callers each on a ClusterClient
    (least outstanding, RetryPolicy(3)): a seeded worker_kill on replica 1
    (healed by the ReplicaSupervisor) and a rolling update on replica 0
    give zero caller errors; the autoscaler scales replica 0 out and its
    burn comes back under the threshold; the restart shows on /metrics."""

    def test_drill(self, monkeypatch):
        controllers = {}

        def factory():
            r = ModelRegistry()
            r.register_model(_drill_model())
            return r

        def core_setup(h):
            core = h.core
            core.slo.set_objective(DRILL, SloObjective(
                p99_ms=SERVICE_S * 2e3, availability=0.95))
            ctl = tfleet.FleetController(
                core, interval_s=0.1, bounds={DRILL: (1, 4)},
                queue_high=2.0, scale_out_cooldown_s=0.25,
                scale_in_cooldown_s=60.0)
            core.fleet = ctl
            ctl.scale_to(DRILL, 1)
            ctl.start()
            controllers[id(core)] = ctl

        with ClusterHarness(factory, n=2, core_setup=core_setup) as ch:
            sup = ReplicaSupervisor(ch)
            monkeypatch.setenv(tfleet.FLEET_STATE_ENV, sup.state.path)
            inj = tchaos.ChaosInjector(rate=1.0, kinds=["worker_kill"],
                                       seed=42, max_faults=1)
            inj.worker_kill_cb = lambda: sup.crash(1)
            policy = tres.RetryPolicy(max_attempts=3, retry_infer=True,
                                      initial_backoff_s=0.02, seed=9)
            errors, stop = [], threading.Event()
            x = np.ones((1, 4), dtype=np.int32)

            def flood():
                try:
                    with ClusterClient(ch.http_urls, protocol="http",
                                       policy="least_outstanding",
                                       retry_policy=policy) as c:
                        i0 = thttp.InferInput("IN", [1, 4], "INT32")
                        i0.set_data_from_numpy(x)
                        while not stop.is_set():
                            out = c.infer(DRILL, [i0], priority=0)
                            np.testing.assert_array_equal(
                                out.as_numpy("OUT"), x)
                except Exception as e:  # noqa: BLE001 - reported below
                    errors.append(repr(e))

            threads = [threading.Thread(target=flood, daemon=True)
                       for _ in range(8)]
            for t in threads:
                t.start()
            core0 = ch.harnesses[0].core
            try:
                _wait(lambda: (core0.slo.burn_rate(DRILL, 300.0) or 0.0)
                      >= core0.slo.burn_threshold, timeout=30,
                      msg="the overload's breach")
                ch.chaos(1, inj)
                assert controllers[id(core0)].rolling_update(
                    DRILL, _drill_model(), bake_s=0.3) == "completed"
                sup.join(timeout=30)
                _wait(lambda: all(
                    (h.core.slo.burn_rate(DRILL, 300.0) or 0.0)
                    < core0.slo.burn_threshold
                    for h in ch.harnesses if h is not None), timeout=40,
                    poll=0.1, msg="the burn under the threshold")
            finally:
                stop.set()
                for t in threads:
                    t.join(timeout=30)
            assert not errors, errors
            assert inj.injected_total == 1
            ctl0 = controllers[id(core0)]
            assert ctl0.scale_events.get((DRILL, "out"), 0) >= 1
            assert ctl0.desired_instances(DRILL) > 1
            assert sup.state.counts() == {"1": 1}
            assert ch.harnesses[1] is not None
            assert core0.registry.get(DRILL).served_version == "2"
            text = urllib.request.urlopen(
                f"http://{ch.http_urls[0]}/metrics",
                timeout=5).read().decode()
            assert 'nv_fleet_worker_restart_total{worker="1"} 1' in text
            assert 'nv_fleet_serving_version{model="scaly"} 2' in text


# -- the sibling-worker shared-memory manifest ------------------------------------

class TestShmManifest:
    def test_regions_resolve_in_a_sibling_core(self, tmp_path, monkeypatch):
        """A system region and a CUDA-kind region registered through one
        core resolve, at first use, in a second core sharing the manifest
        directory (the CUDA region here is a host region of this process,
        found by its uuid; opening a cudaIPC handle needs the card), an
        infer through the second reading its input from the region; an
        unregister through the first drops the second's attachment."""
        from triton_client_tpu_torch.utils import cuda_shared_memory as cudashm
        from triton_client_tpu.server import shm as jshm

        monkeypatch.setenv(tshm.MANIFEST_ENV, str(tmp_path))
        cores = []
        for _ in range(2):
            registry = ModelRegistry()
            registry.register_model(tzoo.make_custom_identity_int32())
            cores.append(InferenceCore(registry))
        a, b = cores[0].system_shm, cores[1].system_shm
        ca, cb = cores[0].cuda_shm, cores[1].cuda_shm
        handle = tsysshm.create_shared_memory_region(
            "sys_r", "/tctshm_fleet_manifest", 64)
        region = cudashm.create_shared_memory_region("cuda_r", 64, 0,
                                                     device="cpu")
        try:
            tsysshm.set_shared_memory_region(
                handle, [np.arange(16, dtype=np.int32)])
            a.register("sys_r", "/tctshm_fleet_manifest", 0, 64)
            ref = ttypes.ShmRef("sys_r", 64, 0)
            assert "sys_r" in b.status(None) and not b._regions
            req = ttypes.InferRequest(model_name=MODEL, inputs=[
                ttypes.InputTensor("INPUT0", "INT32", (1, 16), shm=ref)])
            np.testing.assert_array_equal(
                cores[1].infer(req).outputs[0].data,
                np.arange(16, dtype=np.int32)[None])
            assert b._regions["sys_r"].manifest == \
                a._regions["sys_r"].manifest
            # the reference's registry reads the same manifest entry
            monkeypatch.setenv("TRITON_TPU_SHM_MANIFEST", str(tmp_path))
            assert jshm._manifest_load("sys", "sys_r") == \
                tshm._manifest_load("sys", "sys_r")
            # the CUDA kind: raw handle in the entry, resolved lazily
            cudashm.set_shared_memory_region(
                region, [np.arange(16, dtype=np.float32)])
            ca.register("cuda_r", cudashm.get_raw_handle(region), 0, 64)
            assert cb.has("cuda_r")
            got = cb.read(ttypes.ShmRef("cuda_r", 64, 0), "FP32", [16])
            np.testing.assert_array_equal(np.asarray(got.cpu()),
                                          np.arange(16, dtype=np.float32))
            # unregister through the first: gone from the manifest, and the
            # sibling's attachments drop at their next use or status
            a.unregister("sys_r")
            ca.unregister("cuda_r")
            assert b.status(None) == {} and cb.status(None) == {}
            assert not b.has("sys_r") and not cb.has("cuda_r")
            with pytest.raises(InferError, match="Unable to find"):
                b.read(ref, "INT32", [16])
            assert os.listdir(tmp_path) == []
        finally:
            for reg in (a, b, ca, cb):
                reg.unregister(None)
            for core in cores:
                core.shutdown()
            tsysshm.destroy_shared_memory_region(handle)
            cudashm.destroy_shared_memory_region(region)

    def test_direct_register_evicts_a_stale_sibling_attachment(
            self, tmp_path, monkeypatch):
        """The same registers, unregisters and reads through two registries
        sharing a manifest give the port's registry and the reference's
        the same answers: a register again through the first worker is
        seen by the second, and a direct register of a name that is held
        under the manifest evicts the holder."""
        from triton_client_tpu.server import shm as jshm
        from triton_client_tpu.server.types import InferError as JaxError

        monkeypatch.setenv(tshm.MANIFEST_ENV, str(tmp_path))
        h1 = tsysshm.create_shared_memory_region("r", "/tctshm_fleet_m1", 64)
        h2 = tsysshm.create_shared_memory_region("r", "/tctshm_fleet_m2", 64)
        outcomes = []
        try:
            tsysshm.set_shared_memory_region(h1, [np.zeros(16, np.int32)])
            tsysshm.set_shared_memory_region(h2, [np.ones(16, np.int32)])
            for mod, ref, err in ((tshm, ttypes.ShmRef("r", 64, 0),
                                   InferError),
                                  (jshm, jtypes.ShmRef("r", 64, 0),
                                   JaxError)):
                a, b = mod.SystemShmRegistry(), mod.SystemShmRegistry()
                got = []

                def read(reg):
                    return int(np.asarray(reg.read(ref, "INT32", [16])).sum())

                try:
                    a.register("r", "/tctshm_fleet_m1", 0, 64)
                    got.append(read(b))
                    # re-registered under another key through the first
                    a.unregister("r")
                    a.register("r", "/tctshm_fleet_m2", 0, 64)
                    got.append(read(b))
                    # a direct register on the sibling takes the name over
                    b.register("r", "/tctshm_fleet_m1", 0, 64)
                    got.append(read(b))
                    got.append(read(a))
                    try:  # and again: it evicts its own registration
                        b.register("r", "/tctshm_fleet_m2", 0, 64)
                        got.append("registered")
                    except err as e:
                        got.append(str(e))
                    got.append(read(b))
                    got.append(sorted(b.status(None)))
                finally:
                    a.unregister(None)
                    b.unregister(None)
                outcomes.append(got)
            assert outcomes[0] == outcomes[1]
            assert outcomes[0] == [0, 16, 0, 0, "registered", 16, ["r"]]
        finally:
            tsysshm.destroy_shared_memory_region(h1)
            tsysshm.destroy_shared_memory_region(h2)

    @pytest.mark.parametrize("kind", ["system", "cuda"])
    def test_register_again_through_a_sibling_replaces_the_mapping(
            self, kind, tmp_path, monkeypatch):
        """A region registered directly through one worker, unregistered
        and registered again with other memory through a second: the
        first reads the new memory at its next use, its status shows the
        new registration, and its own register of the name is not refused.
        (The CUDA kind here: host regions of this process, found by their
        uuid; opening a cudaIPC handle needs the card.)"""
        from triton_client_tpu_torch.utils import cuda_shared_memory as cudashm

        monkeypatch.setenv(tshm.MANIFEST_ENV, str(tmp_path))
        made, key = [], f"/tctshm_fleet_again_{os.getpid()}"
        if kind == "system":
            a, b = tshm.SystemShmRegistry(), tshm.SystemShmRegistry()
            for i in range(2):
                h = tsysshm.create_shared_memory_region(
                    f"m{i}", f"{key}_{i}", 64)
                tsysshm.set_shared_memory_region(
                    h, [np.full(16, i + 1, np.int32)])
                made.append(h)

            def register(reg, i):
                reg.register("x", f"{key}_{i}", 0, 64)
        else:
            a, b = tshm.CudaShmRegistry(), tshm.CudaShmRegistry()
            for i in range(2):
                h = cudashm.create_shared_memory_region(f"m{i}", 64, 0,
                                                         device="cpu")
                cudashm.set_shared_memory_region(
                    h, [np.full(16, i + 1, np.int32)])
                made.append(h)

            def register(reg, i):
                reg.register("x", cudashm.get_raw_handle(made[i]), 0, 64)

        ref = ttypes.ShmRef("x", 64, 0)

        def read(reg):
            got = reg.read(ref, "INT32", [16])
            return np.asarray(got.cpu() if hasattr(got, "cpu") else got)

        try:
            register(a, 0)
            np.testing.assert_array_equal(read(a), np.full(16, 1))
            # new connections land on the sibling: the first's use reads
            # the new memory
            b.unregister("x")
            register(b, 1)
            np.testing.assert_array_equal(read(a), np.full(16, 2))
            assert a._regions["x"].manifest == b._regions["x"].manifest
            # and again, the first's status read before any use
            b.unregister("x")
            register(b, 0)
            assert [r.get("key", kind) for r in a.status(None).values()] \
                == [f"{key}_0" if kind == "system" else kind]
            assert "x" not in a._regions
            np.testing.assert_array_equal(read(a), np.full(16, 1))
            # the first's own register of the name is not refused
            b.unregister("x")
            register(a, 1)
            np.testing.assert_array_equal(read(b), np.full(16, 2))
        finally:
            a.unregister(None)
            b.unregister(None)
            for h in made:
                if kind == "system":
                    tsysshm.destroy_shared_memory_region(h)
                else:
                    cudashm.destroy_shared_memory_region(h)


# -- the nv_fleet_* rows -------------------------------------------------------------

class TestFleetMetricRows:
    def test_rows_without_controller(self):
        rows = []
        for zoo, registry_cls, core_cls, mod in (
                (tzoo, ModelRegistry, InferenceCore, tfleet),
                (jzoo, JaxRegistry, JaxCore, jfleet)):
            registry = registry_cls()
            registry.register_model(zoo.make_custom_identity_int32())
            rows.append(mod.collect_fleet_rows(core_cls(registry)))
        assert rows[0] == rows[1]
        assert rows[0]["serving_version"] == [({"model": MODEL}, 1)]
        assert rows[0]["scale"] == [] and rows[0]["rolling_update"] == []

    def test_restart_rows_from_env(self, tmp_path, monkeypatch):
        path = str(tmp_path / "state.json")
        tfleet.SupervisorState(path).record_restart("3")
        monkeypatch.setenv(tfleet.FLEET_STATE_ENV, path)
        registry = ModelRegistry()
        registry.register_model(tzoo.make_custom_identity_int32())
        rows = tfleet.collect_fleet_rows(InferenceCore(registry))
        assert rows["worker_restart"] == [({"worker": "3"}, 1)]

    def test_scale_and_update_rows(self):
        core, ctl = _port_core()
        ctl.bounds[VER] = (1, 8)
        try:
            core.infer(_req(VER, 4))
            ctl.scale_to(VER, 6, direction="out")
            ctl._on_fault_escalation(VER, {})
            rows = tfleet.collect_fleet_rows(core)
            assert rows["instances"] == [({"model": VER}, 6)]
            assert rows["scale"] == [({"model": VER, "direction": "out"}, 1)]
            assert rows["rolling_update"] == [
                ({"model": VER, "outcome": "device_fault_escalated"}, 1)]
        finally:
            core.shutdown()
