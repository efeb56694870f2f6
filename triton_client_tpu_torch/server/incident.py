"""Incident bundles: a postmortem of the process, written when something
went wrong while nobody was looking.

The port's copy of ``triton_client_tpu/server/incident.py``.  The flight
recorder keeps requests; this module keeps the process.  A trigger (an
SLO burning for a while, a sibling worker that crashed, a storm of
flight-recorder captures, a chaos ``mem_pressure`` or ``worker_kill``
draw, a quarantine, ``SIGUSR2``, or ``POST /v2/debug/incident``) makes
:class:`IncidentRecorder` write one directory:

====================  =====================================================
file                  what it holds
====================  =====================================================
manifest.json         schema, trigger and reason, time, pid and replica,
                      the capture's rate and window, each file's status
profile.folded        the host profile of a boosted capture window
                      (collapsed-stack text)
profiler.json         the profiler's snapshot: lag series, GC pauses, the
                      window's top stacks
threads.txt           every thread's stack
flight_recorder.json  the ring and the pinned outliers with span trees
device_stats.json     per-model executions, duty cycle, ticks on the card
costs.json            the cost ledger, per model and tenant
memory.json           the memory governor's ledger
metrics.txt           the whole ``/metrics`` exposition
trace_tail.jsonl      the last lines of the request trace
config.json           the process: argv, versions, the card, environment
incident.json         the recorder's own state (its trigger timeline)
====================  =====================================================

A bundle is written into a temporary directory and renamed into place,
so a reader never lists half of one.  Each trigger class waits
``min_interval_s`` between bundles and the directory keeps the newest
``keep``: a flapping trigger cannot fill the disk.  Each file is written
on its own: a snapshot that raises leaves its error in the manifest and
the other files are written all the same (a process in distress is when
snapshots raise, and half a postmortem is worth more than none).

``device_stats.json``, ``costs.json`` and ``memory.json`` are the port's
own snapshots; ``config.json`` records the ``TRITON_TPU_*``,
``CUDA_*`` and ``PYTORCH_*`` variables, torch's version, its CUDA version
and the card's name where this process opened one.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from .profiler import dump_threads

INCIDENT_DIR_ENV = "TRITON_TPU_INCIDENT_DIR"
MANIFEST_SCHEMA = 1

#: the trigger classes; any other is a caller's bug
TRIGGER_CLASSES = ("slo_burn", "worker_crash", "watchdog_storm", "chaos",
                   "sigusr2", "manual", "device_fault")

_BUNDLE_PREFIX = "incident-"
#: the prefixes of the environment variables a bundle records
_ENV_PREFIXES = ("TRITON_TPU_", "CUDA_", "PYTORCH_")


def default_incident_dir() -> str:
    return (os.environ.get(INCIDENT_DIR_ENV, "")
            or os.path.join(tempfile.gettempdir(), "tc-tpu-incidents"))


def _tail_lines(path: str, n: int, max_bytes: int = 262144) -> List[str]:
    """The last ``n`` lines of ``path``, reading no more than its last
    ``max_bytes`` (a trace file can be large)."""
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        f.seek(max(0, size - max_bytes))
        data = f.read()
    lines = data.decode("utf-8", errors="replace").splitlines()
    if size > max_bytes and lines:
        lines = lines[1:]  # the first line read is cut
    return lines[-n:]


def _torch_fingerprint() -> Dict[str, Any]:
    """torch's version, its CUDA version and the card's name.  torch is
    read only where this process imported it, and the card only where
    this process opened CUDA: a bundle opens nothing."""
    torch = sys.modules.get("torch")
    if torch is None:
        return {"torch": None, "torch_cuda": None, "device": None}
    device = None
    try:
        if torch.cuda.is_initialized():
            device = torch.cuda.get_device_name(torch.cuda.current_device())
    except Exception as e:  # noqa: BLE001 - recorded, the bundle goes on
        device = f"unreadable: {e}"
    return {"torch": str(torch.__version__),
            "torch_cuda": torch.version.cuda, "device": device}


class IncidentRecorder:
    """Writes bounded, atomic postmortem bundles when triggered.

    Built with the core (cheap, nothing runs); ``start()``, called with
    the profiler's when the models have warmed up, starts the watcher of
    the fleet's restart file.  The slow work of a bundle (the capture
    window, the snapshots, the writes) runs on a thread of its own, never
    on a request's thread."""

    def __init__(self, core, dir: Optional[str] = None, keep: int = 8,
                 min_interval_s: float = 60.0,
                 profile_window_s: float = 1.0, profile_hz: float = 97.0,
                 trace_tail_lines: int = 256,
                 breach_sustain: int = 3, breach_window_s: float = 300.0,
                 storm_captures: int = 16, storm_window_s: float = 10.0):
        self.core = core
        self.dir = dir or default_incident_dir()
        self.keep = keep
        self.min_interval_s = min_interval_s
        self.profile_window_s = profile_window_s
        self.profile_hz = profile_hz
        self.trace_tail_lines = trace_tail_lines
        self._lock = threading.Lock()
        self._last_trigger: Dict[str, float] = {}
        self._seq = 0
        self._writers: List[threading.Thread] = []
        # nv_host_incident_total{trigger,outcome}
        self._written: Dict[str, int] = {}
        self._suppressed: Dict[str, int] = {}
        self._history: deque = deque(maxlen=64)  # (ts, kind, reason, path)
        # slo_burn: breach_sustain pins inside breach_window_s
        self.breach_sustain = breach_sustain
        self.breach_window_s = breach_window_s
        self._breach_pins: deque = deque(maxlen=max(breach_sustain, 8))
        # watchdog_storm: storm_captures captures inside storm_window_s
        self.storm_captures = storm_captures
        self.storm_window_s = storm_window_s
        self._capture_times: deque = deque(maxlen=max(storm_captures, 32))
        # worker_crash: the fleet's restart file, watched
        self._watch_stop = threading.Event()
        self._watch_thread: Optional[threading.Thread] = None
        self._seen_restarts: Optional[Dict[str, int]] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        from .fleet import fleet_state_path, worker_restart_counts

        if self._watch_thread is not None or fleet_state_path() is None:
            return
        # the baseline is read here, not at the first poll: a crash inside
        # the first poll interval is an incident, one before start() not
        self._seen_restarts = dict(worker_restart_counts())
        self._watch_stop.clear()
        self._watch_thread = threading.Thread(
            target=self._watch_fleet, daemon=True,
            name="tc-torch-incident-watch")
        self._watch_thread.start()

    def stop(self) -> None:
        self._watch_stop.set()
        t = self._watch_thread
        if t is not None:
            t.join(timeout=5.0)
            self._watch_thread = None
        self.wait()

    def wait(self, timeout_s: float = 10.0) -> None:
        """Wait for the bundles being written (each up to ``timeout_s``):
        a process about to end itself calls this first."""
        with self._lock:
            writers = list(self._writers)
        for w in writers:
            w.join(timeout=timeout_s)

    # -- what triggers a bundle --------------------------------------------
    def note_breach(self, model: str) -> None:
        """One SLO-pinned flight (from the flight recorder).  One pin is
        noise; ``breach_sustain`` inside ``breach_window_s`` are an
        incident."""
        now = time.monotonic()
        with self._lock:
            self._breach_pins.append(now)
            pins = [t for t in self._breach_pins
                    if now - t <= self.breach_window_s]
        if len(pins) >= self.breach_sustain:
            self.trigger("slo_burn", reason=f"model={model} "
                         f"{len(pins)} SLO pins in "
                         f"{self.breach_window_s:.0f}s")

    def note_capture(self) -> None:
        """One flight-recorder capture (failed, slow or chaos); a storm of
        them is an incident."""
        now = time.monotonic()
        with self._lock:
            self._capture_times.append(now)
            recent = [t for t in self._capture_times
                      if now - t <= self.storm_window_s]
        if len(recent) >= self.storm_captures:
            self.trigger("watchdog_storm",
                         reason=f"{len(recent)} flight captures in "
                         f"{self.storm_window_s:.0f}s")

    def _watch_fleet(self) -> None:
        from .fleet import worker_crash_reasons, worker_restart_counts

        while not self._watch_stop.wait(0.5):
            counts = worker_restart_counts()
            seen = self._seen_restarts or {}
            new = sorted(w for w, n in counts.items() if n > seen.get(w, 0))
            if not new:
                continue
            self._seen_restarts = dict(counts)
            reasons = worker_crash_reasons() or {}
            self.trigger("worker_crash", reason=", ".join(
                f"worker {w}: {reasons.get(w, 'unknown')}" for w in new))

    def trigger(self, kind: str, reason: str = "",
                context: Optional[Dict[str, Any]] = None,
                sync: bool = False) -> Optional[str]:
        """Write a bundle of class ``kind``: at once on this thread where
        ``sync``, else on a writer thread.  Returns the bundle's path, or
        None where the class is inside its ``min_interval_s``."""
        if kind not in TRIGGER_CLASSES:
            raise ValueError(f"unknown incident trigger class '{kind}'")
        now = time.monotonic()
        with self._lock:
            last = self._last_trigger.get(kind)
            if last is not None and now - last < self.min_interval_s:
                self._suppressed[kind] = self._suppressed.get(kind, 0) + 1
                return None
            self._last_trigger[kind] = now
            self._seq += 1
            seq = self._seq
        stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime())
        path = os.path.join(self.dir,
                            f"{_BUNDLE_PREFIX}{stamp}-{seq:04d}-{kind}")
        if sync:
            self._write_bundle(path, kind, reason, context)
            return path
        t = threading.Thread(target=self._write_bundle,
                             args=(path, kind, reason, context),
                             daemon=True, name="tc-torch-incident-write")
        with self._lock:
            self._writers = [w for w in self._writers if w.is_alive()]
            self._writers.append(t)
        t.start()
        return path

    # -- writing a bundle --------------------------------------------------
    def _write_bundle(self, path: str, kind: str, reason: str,
                      context: Optional[Dict[str, Any]]) -> None:
        ts = time.time()
        # the staging name holds the pid and the writer's thread: several
        # cores of one process may share a directory and a name
        tmp = os.path.join(
            os.path.dirname(path),
            f".tmp-{os.path.basename(path)}-{os.getpid()}"
            f"-{threading.get_ident()}")
        os.makedirs(tmp, exist_ok=True)
        files: List[Dict[str, Any]] = []

        def put(name: str, produce) -> None:
            # one file at a time: a failing snapshot leaves its error in
            # the manifest, and the bundle goes on
            try:
                data = produce()
                if isinstance(data, (dict, list)):
                    data = json.dumps(data, indent=1, sort_keys=True,
                                      default=str)
                target = os.path.join(tmp, name)
                with open(target, "w", encoding="utf-8") as f:
                    f.write(data)
                files.append({"name": name,
                              "bytes": os.path.getsize(target)})
            except Exception as e:  # noqa: BLE001 - recorded per file
                files.append({"name": name, "error": str(e)})

        core = self.core
        # the capture window first: the snapshots after it describe the
        # state at its end
        put("profile.folded", lambda: core.profiler.capture_window(
            self.profile_window_s, self.profile_hz))
        put("threads.txt", dump_threads)
        put("profiler.json", core.profiler.snapshot)
        put("flight_recorder.json", core.flight_recorder.snapshot)
        put("device_stats.json", core.device_stats.snapshot)
        put("costs.json", core.cost_ledger.snapshot)
        put("memory.json", core.memory.snapshot)
        put("metrics.txt", lambda: _render_metrics(core))
        put("trace_tail.jsonl",
            lambda: "\n".join(self._trace_tail()) + "\n")
        put("config.json", lambda: self._fingerprint(core))
        put("incident.json", self.snapshot)

        manifest = {
            "schema": MANIFEST_SCHEMA,
            "trigger": kind,
            "reason": reason,
            "context": context or {},
            "ts": ts,
            "iso": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(ts)),
            "pid": os.getpid(),
            "replica": getattr(core.tracer, "replica", ""),
            "capture": {"profile_hz": self.profile_hz,
                        "profile_window_s": self.profile_window_s},
            "files": files,
        }
        with open(os.path.join(tmp, "manifest.json"), "w",
                  encoding="utf-8") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
        try:
            os.replace(tmp, path)  # readers list whole bundles only
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)
        with self._lock:
            self._written[kind] = self._written.get(kind, 0) + 1
            self._history.append((ts, kind, reason, path))
        self._retain()

    def _trace_tail(self) -> List[str]:
        base = self.core.tracer._trace_file()
        present = [(os.path.getmtime(p), p)
                   for p in [base] + [f"{base}.{i}" for i in range(16)]
                   if os.path.exists(p)]
        lines: List[str] = []
        # oldest file first, so the tail kept is the newest lines
        for _mtime, p in sorted(present):
            lines.extend(_tail_lines(p, self.trace_tail_lines))
        return lines[-self.trace_tail_lines:]

    @staticmethod
    def _fingerprint(core) -> Dict[str, Any]:
        import platform

        return {
            "pid": os.getpid(),
            "argv": list(sys.argv),
            "python": sys.version.split()[0],
            "platform": platform.platform(),
            "replica": getattr(core.tracer, "replica", ""),
            "models": sorted(m.name for m in
                             core.registry.all_version_models()),
            **_torch_fingerprint(),
            "env": {k: os.environ[k] for k in sorted(os.environ)
                    if k.startswith(_ENV_PREFIXES)},
        }

    def _retain(self) -> None:
        # names sort by time (a UTC stamp, then the sequence): the oldest
        # beyond keep go
        entries = self.list_bundles()
        for e in entries[:max(0, len(entries) - self.keep)]:
            shutil.rmtree(os.path.join(self.dir, e), ignore_errors=True)

    # -- what it shows -----------------------------------------------------
    def list_bundles(self) -> List[str]:
        try:
            return sorted(e for e in os.listdir(self.dir)
                          if e.startswith(_BUNDLE_PREFIX))
        except OSError:
            return []

    def metric_rows(self) -> Dict[str, List[Tuple[Dict[str, str], float]]]:
        with self._lock:
            rows = [({"trigger": k, "outcome": "written"}, float(n))
                    for k, n in sorted(self._written.items())]
            rows += [({"trigger": k, "outcome": "suppressed"}, float(n))
                     for k, n in sorted(self._suppressed.items())]
        return {"incidents": rows}

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            recent = [{"ts": ts, "trigger": k, "reason": r,
                       "bundle": os.path.basename(p)}
                      for ts, k, r, p in self._history]
            written = dict(self._written)
            suppressed = dict(self._suppressed)
        return {
            "dir": self.dir,
            "keep": self.keep,
            "min_interval_s": self.min_interval_s,
            "bundles": self.list_bundles(),
            "written": written,
            "suppressed": suppressed,
            "recent": recent,
        }


def _render_metrics(core) -> str:
    # imported here: metrics imports the core, which builds this recorder
    from .metrics import render_prometheus

    return render_prometheus(core)
