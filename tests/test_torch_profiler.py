"""The port's host profiler (``triton_client_tpu_torch/server/profiler.py``)
against the JAX package's, on the CPU.

* ``classify_thread`` gives the reference's role for every name of the
  reference's own tests and threads; the port's own thread names (an
  ``http.server`` request thread, the harness's serving thread, the
  batcher and its executors, a decode worker, an OpenAI choice) map to
  their roles, and a real request thread of the port's server reads
  ``frontend``;
* ``fold_stack`` and ``dump_threads`` give the reference's text for the
  same frames;
* ``metric_rows`` and ``snapshot`` have the reference's keys;
* the window: overflow into ``~overflow``, epoch rotation, ``hz = 0``
  (no sampler, GC accounting registered and removed);
* capture windows: inline with the sampler off, and boosted on a live
  5 Hz sampler (0.4 s at 100 Hz lands at least 20 samples of a parked
  thread: the boost wakes the sampler, which the reference's does not);
* the lag probe, a thread here, reads a thread that holds the
  interpreter lock; the GC pauses land per generation;
* a served core starts its profiler with the warmup and stops every
  thread of it at shutdown.

Sampling is driven by ``_sample_once`` where the assertion must be exact,
and by short live samplers elsewhere.
"""

import gc
import http.server
import sys
import threading
import time
import urllib.request

import pytest

from triton_client_tpu.server import profiler as jprof
from triton_client_tpu_torch.server import profiler as tprof
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import ServerHarness

# the reference's own test names and the names its threads take
REFERENCE_NAMES = [
    "llama-decode-worker", "llama-readback", "llama-gen", "MainThread",
    "tc-tpu-server", "tc-tpu-server-2", "asyncio_0",
    "ThreadPoolExecutor-0_1", "tc-tpu-host-profiler", "random-thread",
    "llama_decode-readback_0", "llama_generate-gen_3", "tc-tpu-otlp",
    "", "Thread-7",
]

# the port's threads and the role each must read
PORT_NAMES = [
    ("Thread-12 (process_request_thread)", "frontend"),
    ("tc-torch-http", "frontend"),
    ("oai-choice-0", "frontend"),
    ("batcher-longctx_tpu", "batcher"),
    ("batch-longctx_tpu_0", "batcher"),
    ("llama_decode-decode-worker", "decode"),
    ("llama_decode-readback_1", "readback"),
    ("tc-torch-host-profiler", "other"),
    ("tc-torch-lag-probe-frontend", "other"),
    ("tc-torch-http_0", "other"),  # the HTTP client's async pool
]


class _Parked:
    """A thread parked in one function until released."""

    def __init__(self, name):
        self.gate = threading.Event()
        self.ready = threading.Event()
        self.thread = threading.Thread(target=self._park, name=name,
                                       daemon=True)
        self.thread.start()
        assert self.ready.wait(5)

    def _park(self):
        self.ready.set()
        self.gate.wait(timeout=30)

    def release(self):
        self.gate.set()
        self.thread.join(timeout=5)
        assert not self.thread.is_alive()


@pytest.mark.parametrize("name", REFERENCE_NAMES)
def test_reference_names_read_the_reference_role(name):
    assert tprof.classify_thread(name) == jprof.classify_thread(name)


@pytest.mark.parametrize("name,role", PORT_NAMES)
def test_port_names_read_their_role(name, role):
    assert tprof.classify_thread(name) == role


def test_a_request_thread_of_the_port_s_server_is_frontend():
    """The thread that ``http.server`` starts per connection, named by
    ``threading`` after its target, reads ``frontend``; the reference's
    classifier puts it under ``other``."""
    seen = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            seen.append(threading.current_thread().name)
            self.send_response(204)
            self.end_headers()

        def log_message(self, *args):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        urllib.request.urlopen(
            f"http://127.0.0.1:{srv.server_address[1]}/").read()
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=5)
    assert seen and seen[0].endswith("(process_request_thread)")
    assert tprof.classify_thread(seen[0]) == "frontend"
    assert jprof.classify_thread(seen[0]) == "other"


@pytest.mark.parametrize("raw,want", [
    (None, tprof.DEFAULT_PROFILE_HZ), ("0", 0.0), ("-5", 0.0),
    ("banana", tprof.DEFAULT_PROFILE_HZ), ("97", 97.0)])
def test_hz_from_env_as_reference(monkeypatch, raw, want):
    if raw is None:
        monkeypatch.delenv(tprof.PROFILE_HZ_ENV, raising=False)
    else:
        monkeypatch.setenv(tprof.PROFILE_HZ_ENV, raw)
    assert tprof.PROFILE_HZ_ENV == jprof.PROFILE_HZ_ENV
    assert tprof.profile_hz_from_env() == jprof.profile_hz_from_env() \
        == want


def _deep(n):
    if n == 0:
        return sys._getframe()
    return _deep(n - 1)


@pytest.mark.parametrize("depth,limit", [(3, 64), (100, 8), (100, 64)])
def test_fold_stack_equals_reference(depth, limit):
    frame = _deep(depth)
    folded = tprof.fold_stack(frame, limit=limit)
    assert folded == jprof.fold_stack(frame, limit=limit)
    assert folded.split(";")[-1] == "test_torch_profiler.py:_deep"
    assert len(folded.split(";")) <= limit


def test_dump_threads_equals_reference(monkeypatch):
    """The same frames (a parked thread's, frozen while both read them)
    give the same text, names and roles included."""
    parked = _Parked("dump-decode-worker")
    try:
        frames = {parked.thread.ident:
                  sys._current_frames()[parked.thread.ident]}
        monkeypatch.setattr(sys, "_current_frames", lambda: frames)
        text = tprof.dump_threads()
        ref = jprof.dump_threads()
    finally:
        monkeypatch.undo()
        parked.release()
    assert text == ref
    assert "dump-decode-worker" in text and "[role=decode]" in text
    assert 'File "' in text


def test_metric_rows_and_snapshot_have_the_reference_s_keys():
    port, ref = tprof.HostProfiler(hz=0), jprof.HostProfiler(hz=0)
    for p in (port, ref):
        p._sample_once()
        p._gc_events.append((2, 1500))
    rows, ref_rows = port.metric_rows(), ref.metric_rows()
    assert set(rows) == set(ref_rows) == {"loop_lag", "gc_pause", "samples"}
    for key in rows:
        assert ({tuple(sorted(l)) for l, _ in rows[key]}
                == {tuple(sorted(l)) for l, _ in ref_rows[key]}), key
    assert rows["gc_pause"] == ref_rows["gc_pause"] == \
        [({"generation": "2"}, 1.5)]
    snap, ref_snap = port.snapshot(), ref.snapshot()
    assert set(snap) == set(ref_snap)
    assert set(snap["top_stacks"][0]) == set(ref_snap["top_stacks"][0])
    assert snap["gc"] == ref_snap["gc"]
    assert (snap["hz"], snap["enabled"]) == (0.0, False)


def test_max_stacks_overflow_folds():
    parked = _Parked("overflow-park")
    try:
        p = tprof.HostProfiler(hz=0, max_stacks=1)
        p._sample_once()
        text = p.collapsed()
    finally:
        parked.release()
    assert "~overflow" in text
    # one stack kept; the others fold into each role's overflow
    assert sum(1 for _role, stack in p._epoch if stack != "~overflow") == 1


def test_epoch_rotation_keeps_the_previous_window():
    p = tprof.HostProfiler(hz=0, window_s=0.05)
    p._sample_once()
    first = dict(p._epoch)
    assert first
    time.sleep(0.08)
    p._sample_once()
    assert p._prev_epoch == first
    assert p.collapsed().strip()
    top = p.top_stacks(n=2)
    assert len(top) <= 2
    assert [c for _, _, c in top] == sorted([c for _, _, c in top],
                                            reverse=True)


def test_hz_zero_starts_no_sampler_and_keeps_gc_accounting():
    p = tprof.HostProfiler(hz=0)
    p.start()
    try:
        assert p._thread is None
        assert p._on_gc in gc.callbacks
    finally:
        p.stop()
    assert p._on_gc not in gc.callbacks


def test_live_sampler_roles_and_idempotent_lifecycle():
    worker = _Parked("m-decode-worker")
    p = tprof.HostProfiler(hz=200.0)
    p.start()
    p.start()
    try:
        deadline = time.monotonic() + 5.0
        while (p._samples_by_role.get("decode", 0) < 3
               and time.monotonic() < deadline):
            time.sleep(0.01)
        sampler = p._thread
    finally:
        p.stop()
        p.stop()
        worker.release()
    assert not sampler.is_alive() and p._thread is None
    assert p._samples_by_role.get("decode", 0) >= 3
    text = p.collapsed(role="decode")
    for line in text.strip().splitlines():
        stack, _, count = line.rpartition(" ")
        assert stack.startswith("decode;") and int(count) >= 1
    assert "tc-torch-host-profiler" not in p.collapsed()
    assert "profiler.py:_run" not in p.collapsed()  # nor itself


def test_inline_capture_when_the_sampler_is_off():
    worker = _Parked("cap-decode-worker")
    p = tprof.HostProfiler(hz=0)
    try:
        text = p.capture_window(duration_s=0.2, hz=50.0)
    finally:
        worker.release()
    assert "decode;" in text
    assert p._captures == []


@pytest.mark.parametrize("base_hz", [5.0, 1.0])
def test_boosted_capture_samples_at_its_rate_from_its_start(base_hz):
    """0.4 s at 100 Hz on a 5 Hz (and a 1 Hz) sampler: the boost wakes the
    sampler, so the window is sampled at 100 Hz from its first moment (at
    least 20 samples of a parked thread; a sampler that waited out its
    base period would take none at 1 Hz)."""
    worker = _Parked("cap2-decode-worker")
    p = tprof.HostProfiler(hz=base_hz)
    p.start()
    try:
        deadline = time.monotonic() + 5.0
        while not p._samples_by_role and time.monotonic() < deadline:
            time.sleep(0.005)
        # the sampler took its first sample and waits out its period now
        text = p.capture_window(duration_s=0.4, hz=100.0)
    finally:
        p.stop()
        worker.release()
    decode = sum(int(line.rpartition(" ")[2])
                 for line in text.strip().splitlines()
                 if line.startswith("decode;"))
    assert decode >= 20, text
    assert p._captures == []


def test_lag_probe_reads_a_thread_that_holds_the_interpreter_lock():
    """A thread runs Python for 0.6 s with a switch interval of 0.2 s: the
    probe, waking from its timed wait, waits for the interpreter lock, and
    that wait is its lag."""
    p = tprof.HostProfiler(hz=0)
    p.install_loop_probe("lp", interval_s=0.02)
    p.install_loop_probe("lp", interval_s=0.02)  # one probe per name
    assert list(p._loops) == ["lp"]

    def spin(seconds):
        end = time.monotonic() + seconds
        while time.monotonic() < end:
            pass

    old = sys.getswitchinterval()
    try:
        time.sleep(0.1)  # the probe's first wakes, unloaded
        sys.setswitchinterval(0.2)
        hog = threading.Thread(target=spin, args=(0.6,), daemon=True)
        hog.start()
        hog.join(timeout=10)
        assert not hog.is_alive()
    finally:
        sys.setswitchinterval(old)
    deadline = time.monotonic() + 5.0
    while (p.loop_lag()["lp"]["max_us"] <= 50_000
           and time.monotonic() < deadline):
        time.sleep(0.01)
    probes = list(p._probes)
    p.stop()
    assert all(not t.is_alive() for t in probes)
    assert p.loop_lag()["lp"]["max_us"] > 50_000
    rows = p.metric_rows()["loop_lag"]
    assert rows and rows[0][0] == {"loop": "lp"}
    series = p.snapshot()["loop_lag"]["lp"]["series"]
    assert series and set(series[0]) == {"ts_mono", "lag_us"}


def test_gc_pauses_land_per_generation():
    p = tprof.HostProfiler(hz=0)
    p.start()
    try:
        deadline = time.monotonic() + 5.0
        rows: dict = {}
        while time.monotonic() < deadline:
            gc.collect()
            rows = {labels["generation"]: value
                    for labels, value in p.metric_rows()["gc_pause"]}
            if rows.get("2", 0.0) > 0.0:
                break
            time.sleep(0.01)
    finally:
        p.stop()
    assert rows.get("2", 0.0) > 0.0
    assert p.snapshot()["gc"]["2"]["collections"] >= 1


def test_a_served_core_starts_and_stops_its_profiler():
    h = ServerHarness(ModelRegistry())
    h.core.profiler.hz = 50.0
    with h:
        prof = h.core.profiler
        assert prof._thread is not None and prof._thread.is_alive()
        assert "frontend" in prof._loops  # the HTTP listener's probe
        assert prof._on_gc in gc.callbacks
        threads = [prof._thread, *prof._probes]
    assert all(not t.is_alive() for t in threads)
    assert prof._on_gc not in gc.callbacks


def test_set_hz_stops_and_restarts_the_sampler_alone():
    """The rate changes while serving: 0 ends the sampler's thread and
    leaves the lag probe and the GC accounting; a rate starts it again."""
    p = tprof.HostProfiler(hz=100.0)
    p.start()
    try:
        p.install_loop_probe("lp", interval_s=0.02)
        first = p._thread
        p.set_hz(0)
        assert not first.is_alive() and p._thread is None
        probe = p._probes[0]
        assert probe.is_alive() and p._on_gc in gc.callbacks
        before = sum(p._samples_by_role.values())
        time.sleep(0.1)
        assert sum(p._samples_by_role.values()) == before
        p.set_hz(100.0)
        assert p._thread is not None and p._thread.is_alive()
        deadline = time.monotonic() + 5.0
        while (sum(p._samples_by_role.values()) == before
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert sum(p._samples_by_role.values()) > before
    finally:
        p.stop()
    assert not probe.is_alive() and p._thread is None
