"""The port's incident bundles (``server/incident.py``,
``tools/incident_report.py``, the debug routes, the CLI's SIGUSR2) against
the JAX package's, on the CPU.

* a manual bundle has the reference's file names and manifest keys, each
  package's recorder on its own core, and none of its files failed;
* the rate limit per trigger class and the ``keep`` retention give the
  reference's answers step for step; the ``slo_burn`` and
  ``watchdog_storm`` detectors fire on the same sequences; the fleet
  watcher baselines at start and names the crashed worker and its reason;
* a chaos ``mem_pressure`` draw, a ``worker_kill`` drill (the dying
  replica's ``chaos`` bundle, then the sibling's ``worker_crash``) and a
  quarantine each write one complete bundle;
* ``GET /v2/debug/profile`` and ``GET`` / ``POST /v2/debug/incident``
  answer as the reference server's do, on the HTTP port and on the
  metrics port;
* the reference's ``incident_report`` and the port's render the same text
  for the same bundle, a bundle of either package;
* a ``--frontends 2 --device cpu`` CLI fleet writes a ``sigusr2`` bundle
  when one worker is sent SIGUSR2, and counts it on that worker's
  ``/metrics``.

The recorders run with a short capture window (0.05 s at 50 Hz) and the
rate limit set per test, as the reference's tests do.
"""

import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from triton_client_tpu.models import zoo as jzoo
from triton_client_tpu.server import InferenceCore as JaxCore
from triton_client_tpu.server import ModelRegistry as JaxRegistry
from triton_client_tpu.server.incident import IncidentRecorder as JaxRecorder
from triton_client_tpu.server.testing import ServerHarness as JaxHarness
from triton_client_tpu.tools import incident_report as jreport
from triton_client_tpu_torch.models import zoo as tzoo
from triton_client_tpu_torch.server.chaos import ChaosInjector
from triton_client_tpu_torch.server.core import InferenceCore
from triton_client_tpu_torch.server.fleet import (FLEET_STATE_ENV,
                                                  SupervisorState,
                                                  worker_crash_reasons)
from triton_client_tpu_torch.server.http_server import MetricsServer
from triton_client_tpu_torch.server.incident import (MANIFEST_SCHEMA,
                                                     TRIGGER_CLASSES,
                                                     IncidentRecorder)
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import (ClusterHarness,
                                                    ReplicaSupervisor,
                                                    ServerHarness, free_port)
from triton_client_tpu_torch.server.types import InferRequest, InputTensor
from triton_client_tpu_torch.tools import incident_report as treport

from test_torch_fleet import _Fleet, _metric, _wait

#: every file of a bundle (the reference's test pins the same set)
BUNDLE_FILES = {
    "manifest.json", "profile.folded", "threads.txt", "profiler.json",
    "flight_recorder.json", "device_stats.json", "costs.json",
    "memory.json", "metrics.txt", "trace_tail.jsonl", "config.json",
    "incident.json",
}


def _port_core():
    registry = ModelRegistry()
    registry.register_model(tzoo.make_custom_identity_int32())
    return InferenceCore(registry)


def _jax_core():
    registry = JaxRegistry()
    registry.register_model(jzoo.make_custom_identity_int32())
    return JaxCore(registry)


def _recorder(cls, core, path, **kw):
    kw.setdefault("profile_window_s", 0.05)
    kw.setdefault("profile_hz", 50.0)
    rec = cls(core, dir=str(path), **kw)
    os.makedirs(rec.dir, exist_ok=True)
    core.incidents = rec
    core.flight_recorder.incidents = rec
    return rec


def _pair(tmp_path, **kw):
    """(port recorder, reference recorder), each on its own core."""
    return (_recorder(IncidentRecorder, _port_core(), tmp_path / "port",
                      **kw),
            _recorder(JaxRecorder, _jax_core(), tmp_path / "jax", **kw))


def _manifest(bundle):
    with open(os.path.join(bundle, "manifest.json")) as f:
        return json.load(f)


def _suffixes(rec):
    """Each bundle's sequence and class (the stamp is the time)."""
    return [b.split("-", 3)[3] for b in rec.list_bundles()]


class _Parked:
    """A thread parked until released: the inline capture samples it."""

    def __init__(self):
        self.gate = threading.Event()
        self.thread = threading.Thread(target=self.gate.wait, args=(30,),
                                       name="bundle-decode-worker",
                                       daemon=True)
        self.thread.start()

    def release(self):
        self.gate.set()
        self.thread.join(timeout=5)


def test_trigger_classes_equal_reference():
    from triton_client_tpu.server import incident as jinc

    assert TRIGGER_CLASSES == jinc.TRIGGER_CLASSES
    assert MANIFEST_SCHEMA == jinc.MANIFEST_SCHEMA


def test_manual_bundle_has_the_reference_s_files_and_manifest(tmp_path):
    port, ref = _pair(tmp_path)
    parked = _Parked()
    try:
        bundles = [rec.trigger("manual", reason="unit test", sync=True)
                   for rec in (port, ref)]
    finally:
        parked.release()
    for rec in (port, ref):
        assert not [e for e in os.listdir(rec.dir) if e.startswith(".tmp")]
    listed = [set(os.listdir(b)) for b in bundles]
    assert listed[0] == listed[1] == BUNDLE_FILES
    m, jm = (_manifest(b) for b in bundles)
    assert set(m) == set(jm)
    assert set(m["capture"]) == set(jm["capture"])
    assert [f["name"] for f in m["files"]] == \
        [f["name"] for f in jm["files"]]
    assert [f for f in m["files"] if "error" in f] == []
    assert (m["schema"], m["trigger"], m["reason"], m["pid"]) == \
        (MANIFEST_SCHEMA, "manual", "unit test", os.getpid())
    bundle = bundles[0]
    assert treport.parse_folded(
        open(os.path.join(bundle, "profile.folded")).read())
    with open(os.path.join(bundle, "metrics.txt")) as f:
        text = f.read()
    for family in ("nv_host_profile_samples_total", "nv_host_incident_total",
                   "nv_host_gc_pause_us_total", "nv_host_loop_lag_us"):
        assert f"# HELP {family}" in text
    with open(os.path.join(bundle, "config.json")) as f:
        fp = json.load(f)
    with open(os.path.join(bundles[1], "config.json")) as f:
        jfp = json.load(f)
    assert fp["models"] == jfp["models"] == ["custom_identity_int32"]
    assert set(jfp) - {"env"} <= set(fp)
    assert {"torch", "torch_cuda", "device"} <= set(fp)
    assert all(k.startswith(("TRITON_TPU_", "CUDA_", "PYTORCH_"))
               for k in fp["env"])


def test_a_failing_snapshot_is_recorded_and_the_rest_written(tmp_path):
    port, _ = _pair(tmp_path)
    port.core.device_stats.snapshot = lambda: (_ for _ in ()).throw(
        RuntimeError("distressed"))
    bundle = port.trigger("manual", context={"via": "test"}, sync=True)
    m = _manifest(bundle)
    by_name = {f["name"]: f for f in m["files"]}
    assert by_name["device_stats.json"]["error"] == "distressed"
    assert all("error" not in f for name, f in by_name.items()
               if name != "device_stats.json")
    assert m["context"] == {"via": "test"}
    with pytest.raises(ValueError, match="unknown incident trigger"):
        port.trigger("reboot")


def test_rate_limit_step_for_step(tmp_path):
    port, ref = _pair(tmp_path, min_interval_s=60.0)
    steps = ["manual", "manual", "sigusr2", "manual", "device_fault"]
    outcomes = [[rec.trigger(kind, sync=True) is not None for kind in steps]
                for rec in (port, ref)]
    assert outcomes[0] == outcomes[1] == [True, False, True, False, True]
    assert port.metric_rows() == ref.metric_rows()
    assert port.snapshot()["suppressed"] == ref.snapshot()["suppressed"] \
        == {"manual": 2}


def test_keep_step_for_step(tmp_path):
    port, ref = _pair(tmp_path, keep=3, min_interval_s=0.0)
    for i in range(6):
        for rec in (port, ref):
            assert rec.trigger("manual", reason=f"flap {i}", sync=True)
        assert _suffixes(port) == _suffixes(ref)
    assert _suffixes(port) == ["0004-manual", "0005-manual", "0006-manual"]
    assert port.snapshot()["written"] == ref.snapshot()["written"] \
        == {"manual": 6}


@pytest.mark.parametrize("detector,kind,kw", [
    ("note_breach", "slo_burn", {"breach_sustain": 3}),
    ("note_capture", "watchdog_storm", {"storm_captures": 3}),
])
def test_detectors_fire_on_the_same_sequences(tmp_path, detector, kind, kw):
    port, ref = _pair(tmp_path, min_interval_s=0.0, **kw)
    for n in range(1, 5):
        for rec in (port, ref):
            if detector == "note_breach":
                rec.note_breach("m")
            else:
                rec.note_capture()
            rec.stop()  # joins the writer
        assert _suffixes(port) == _suffixes(ref), n
    assert _suffixes(port) == [f"0001-{kind}", f"0002-{kind}"]
    reasons = [_manifest(os.path.join(r.dir, r.list_bundles()[0]))["reason"]
               for r in (port, ref)]
    assert reasons[0] == reasons[1]


def test_core_wires_the_flight_recorder_escalation():
    core = _port_core()
    assert core.flight_recorder.incidents is core.incidents


def test_fleet_watcher_baselines_then_triggers(tmp_path, monkeypatch):
    state = SupervisorState(str(tmp_path / "fleet-state.json"))
    state.record_restart("0", reason="signal:SIGTERM")  # before the start
    monkeypatch.setenv(FLEET_STATE_ENV, state.path)
    port, _ = _pair(tmp_path, min_interval_s=0.0)
    port.start()
    try:
        assert port._seen_restarts == {"0": 1}
        time.sleep(0.6)
        assert port.list_bundles() == []
        time.sleep(0.01)
        state.record_restart("1", reason="signal:SIGKILL")
        _wait(lambda: any(b.endswith("-worker_crash")
                          for b in port.list_bundles()),
              timeout=15, msg="worker_crash bundle")
    finally:
        port.stop()
    bundle = os.path.join(port.dir, port.list_bundles()[-1])
    assert _manifest(bundle)["reason"] == "worker 1: signal:SIGKILL"


def test_no_watcher_without_the_state_file(tmp_path, monkeypatch):
    monkeypatch.delenv(FLEET_STATE_ENV, raising=False)
    port, _ = _pair(tmp_path)
    port.start()
    assert port._watch_thread is None
    port.stop()


def _req(model="custom_identity_int32", n=4):
    return InferRequest(
        model_name=model,
        inputs=[InputTensor("INPUT0", "INT32", (1, n),
                            data=np.ones((1, n), np.int32))])


def test_mem_pressure_draw_bundles_the_governor(tmp_path):
    core = _port_core()
    rec = _recorder(IncidentRecorder, core, tmp_path / "inc",
                    min_interval_s=0.0)
    core.memory.budget_bytes = 1 << 20
    core.chaos = ChaosInjector(rate=1.0, kinds=["mem_pressure"], seed=7,
                               max_faults=1, pressure_s=0.3,
                               pressure_factor=0.25)
    resp = core.infer(_req())  # the drawing request goes on
    assert resp.outputs[0].data is not None
    rec.stop()
    bundles = rec.list_bundles()
    assert len(bundles) == 1 and bundles[0].endswith("-chaos")
    bundle = os.path.join(rec.dir, bundles[0])
    m = _manifest(bundle)
    assert m["reason"] == ("mem_pressure on custom_identity_int32 "
                           "(factor=0.25, window=0.3s)")
    assert [f for f in m["files"] if "error" in f] == []
    with open(os.path.join(bundle, "memory.json")) as f:
        assert json.load(f)["pressure_events"] >= 1
    report = treport.render_report(bundle)
    assert report == jreport.render_report(bundle)
    for text in ("INCIDENT POSTMORTEM", "mem_pressure", "THIS BUNDLE",
                 "Memory governor"):
        assert text in report


def test_quarantine_writes_a_device_fault_bundle(tmp_path):
    core = _port_core()
    rec = _recorder(IncidentRecorder, core, tmp_path / "inc")
    try:
        core.device_faults.quarantine("custom_identity_int32",
                                      "device_error fault")
        core.device_faults.quarantine("custom_identity_int32", "again")
        rec.stop()
    finally:
        core.shutdown()
    bundles = rec.list_bundles()
    assert len(bundles) == 1 and bundles[0].endswith("-device_fault")
    m = _manifest(os.path.join(rec.dir, bundles[0]))
    assert m["reason"] == ("model 'custom_identity_int32' quarantined: "
                           "device_error fault")
    assert m["context"] == {"model": "custom_identity_int32",
                            "reason": "device_error fault"}
    assert [f for f in m["files"] if "error" in f] == []


def test_worker_kill_drill_bundles_the_victim_then_the_sibling(
        tmp_path, monkeypatch):
    """A seeded worker_kill on replica 1: the dying replica writes its
    ``chaos`` bundle before the kill, the supervisor restarts it with the
    reason ``chaos:worker_kill``, and replica 0's fleet watcher writes a
    ``worker_crash`` bundle naming it."""
    state_path = str(tmp_path / "fleet-state.json")
    monkeypatch.setenv(FLEET_STATE_ENV, state_path)
    root = tmp_path / "incidents"

    def factory():
        registry = ModelRegistry()
        registry.register_model(tzoo.make_custom_identity_int32())
        return registry

    def core_setup(h):
        inc = h.core.incidents
        inc.dir = str(root / h.core.tracer.replica)
        os.makedirs(inc.dir, exist_ok=True)
        inc.profile_window_s = 0.05
        inc.min_interval_s = 0.0

    with ClusterHarness(factory, n=2, core_setup=core_setup) as ch:
        sup = ReplicaSupervisor(ch, state_path=state_path)
        survivor = ch.harnesses[0].core
        inj = ChaosInjector(rate=1.0, kinds=["worker_kill"], seed=1,
                            max_faults=1)
        inj.worker_kill_cb = lambda: sup.crash(1)
        ch.chaos(1, inj)
        with pytest.raises(Exception):
            ch.harnesses[1].core.infer(_req())
        sup.join(timeout=30)
        assert worker_crash_reasons(state_path) == {"1": "chaos:worker_kill"}
        survivor_dir = str(root / "replica-0")
        _wait(lambda: any(b.endswith("-worker_crash")
                          for b in os.listdir(survivor_dir)),
              timeout=15, msg="the sibling's worker_crash bundle")
        survivor.incidents.stop()
        rows = survivor.incidents.metric_rows()["incidents"]
        assert ({"trigger": "worker_crash", "outcome": "written"}, 1.0) \
            in rows
    victim_dir = str(root / "replica-1")
    chaos = [b for b in os.listdir(victim_dir) if b.endswith("-chaos")]
    assert len(chaos) == 1
    victim = os.path.join(victim_dir, chaos[0])
    assert _manifest(victim)["reason"] == \
        "worker_kill on custom_identity_int32"
    assert set(os.listdir(victim)) == BUNDLE_FILES
    crash = [b for b in os.listdir(str(root / "replica-0"))
             if b.endswith("-worker_crash")][0]
    m = _manifest(os.path.join(str(root / "replica-0"), crash))
    assert (m["trigger"], m["replica"]) == ("worker_crash", "replica-0")
    assert "worker 1: chaos:worker_kill" in m["reason"]
    report = treport.render_report(os.path.join(str(root / "replica-0"),
                                                crash))
    for text in ("worker_crash", "chaos:worker_kill", "Trigger timeline",
                 "Host profile"):
        assert text in report


def _get(url, body=None):
    """(status, content type, body bytes) of a GET, or a POST of
    ``body``."""
    req = urllib.request.Request(url, data=body,
                                 method="POST" if body is not None
                                 else "GET")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _debug_answers(base, inc):
    """The debug routes' answers, with what differs by package masked."""
    out = {}
    code, ctype, body = _get(f"{base}/v2/debug/profile")
    out["profile"] = (code, ctype.split(";")[0],
                      bool(treport.parse_folded(body.decode())))
    code, _, body = _get(f"{base}/v2/debug/profile?role=frontend")
    out["role"] = (code, all(line.startswith("frontend;")
                             for line in body.decode().split("\n") if line))
    code, ctype, body = _get(f"{base}/v2/debug/profile?format=json")
    out["json"] = (code, ctype.split(";")[0], sorted(json.loads(body)))
    code, _, body = _get(f"{base}/v2/debug/incident")
    status = json.loads(body)
    out["status"] = (code, sorted(status), status["bundles"])
    code, _, body = _get(f"{base}/v2/debug/incident",
                         json.dumps({"reason": "operator poke"}).encode())
    answer = json.loads(body)
    out["post"] = (code, answer["status"], os.path.isdir(answer["bundle"]),
                   _manifest(answer["bundle"])["reason"])
    inc.min_interval_s = 3600.0
    code, _, body = _get(f"{base}/v2/debug/incident", b"")
    out["limited"] = (code, json.loads(body))
    code, _, body = _get(f"{base}/v2/debug/incident", b"[1]")
    out["bad body"] = (code, json.loads(body))
    inc.min_interval_s = 0.0
    return out


def _configure(core, path):
    inc = core.incidents
    inc.dir = str(path)
    os.makedirs(inc.dir, exist_ok=True)
    inc.profile_window_s = 0.05
    inc.min_interval_s = 0.0
    core.profiler._sample_once()  # folded stacks without waiting


def test_debug_routes_answer_as_the_reference_server(tmp_path):
    jreg = JaxRegistry()
    jreg.register_model(jzoo.make_custom_identity_int32())
    treg = ModelRegistry()
    treg.register_model(tzoo.make_custom_identity_int32())
    with JaxHarness(jreg) as jh, ServerHarness(treg) as th:
        _configure(jh.core, tmp_path / "jax")
        _configure(th.core, tmp_path / "port")
        ref = _debug_answers(f"http://{jh.http_url}", jh.core.incidents)
        port = _debug_answers(f"http://{th.http_url}", th.core.incidents)
        # the same routes on the port's metrics listener
        mport = free_port()
        srv = MetricsServer(th.core, "127.0.0.1", mport)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        try:
            _configure(th.core, tmp_path / "port-metrics")
            metrics = _debug_answers(f"http://127.0.0.1:{mport}",
                                     th.core.incidents)
        finally:
            srv.shutdown()
            srv.server_close()
            t.join(timeout=10)
    assert port == ref
    assert metrics == ref
    assert port["post"] == (200, "written", True, "operator poke")
    assert port["limited"] == (202, {"status": "rate_limited",
                                     "bundle": None})
    assert port["bad body"][0] == 400


def _both_render(bundle):
    text = treport.render_report(bundle)
    assert text == jreport.render_report(bundle)
    return text


def test_both_reports_render_a_bundle_of_either_package(tmp_path):
    port, ref = _pair(tmp_path, min_interval_s=0.0)
    for rec in (port, ref):
        # a timeline, a suppressed class and a pinned flight to show
        rec.trigger("sigusr2", reason="first", sync=True)
        rec.min_interval_s = 60.0
        rec.trigger("sigusr2", sync=True)
    port.core.infer(_req())
    for rec in (port, ref):
        bundle = rec.trigger("manual", reason="second", sync=True)
        text = _both_render(bundle)
        assert "THIS BUNDLE" in text and "sigusr2=1" in text
        assert "Process fingerprint" in text


def test_report_tools_answer_alike(tmp_path, capsys):
    port, _ = _pair(tmp_path, min_interval_s=0.0)
    port.trigger("manual", reason="first", sync=True)
    port.trigger("manual", reason="second", sync=True)
    outs = []
    for tool in (treport, jreport):
        out = str(tmp_path / f"{tool.__name__}.txt")
        assert tool.main(["--latest", port.dir, "-o", out]) == 0
        outs.append(open(out).read())
        bundle = os.path.join(port.dir, port.list_bundles()[0])
        assert tool.main([bundle]) == 0
        outs.append(capsys.readouterr().out)
        assert tool.main([str(tmp_path / "nope")]) == 1
        assert tool.main(["--latest", str(tmp_path / "empty")]) == 1
        outs.append(capsys.readouterr().err)
    assert outs[:3] == outs[3:]
    assert "second" in outs[0] and "first" in outs[1]
    text = ("frontend;a.py:f;b.py:g 7\ndecode;c.py:h 12\n"
            "garbage line without count\n")
    assert treport.parse_folded(text) == jreport.parse_folded(text) == \
        [("decode", "c.py:h", 12), ("frontend", "a.py:f;b.py:g", 7)]


def test_sigusr2_writes_a_bundle_in_a_cli_fleet(tmp_path):
    """SIGUSR2 to one worker of a ``--frontends 2`` fleet: that worker
    writes a ``sigusr2`` bundle, serves on, and counts it."""
    inc = tmp_path / "incidents"
    fleet = _Fleet("--incident-dir", str(inc), "--profile-hz", "19")
    try:
        fleet.wait_workers()
        os.kill(fleet.pids[0], signal.SIGUSR2)
        _wait(lambda: any(b.endswith("-sigusr2") for b in os.listdir(inc)
                          if b.startswith("incident-")),
              timeout=30, poll=0.1, msg="the sigusr2 bundle: " + fleet.tail())
        _wait(lambda: _metric(fleet.metrics_port,
                              'nv_host_incident_total{trigger="sigusr2",'
                              'outcome="written"}') == 1.0,
              timeout=15, poll=0.1, msg="the count on worker 0")
        assert _metric(fleet.metrics_port + 1, "nv_host_incident_total") \
            in (None, 0.0)
        assert any(f.startswith("faulthandler-") for f in os.listdir(inc))
        assert any(line.startswith("incident capture: dir=")
                   for line in fleet.lines)
    finally:
        assert fleet.close() == 0, fleet.tail()
    bundle = treport.find_latest(str(inc))
    m = _manifest(bundle)
    assert (m["trigger"], m["reason"], m["pid"]) == \
        ("sigusr2", "operator SIGUSR2", fleet.pids[0])
    assert m["replica"].endswith("#w0")
    assert [f for f in m["files"] if "error" in f] == []
    assert "sigusr2" in _both_render(bundle)
