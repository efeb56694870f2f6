"""The server's view of its own host: which threads hold the process, how
late a frontend thread wakes, and how long garbage collection stops it.

The port's copy of ``triton_client_tpu/server/profiler.py``.  The card's
side of a request is measured by the device statistics and the cost
ledger; the Python that feeds the card is measured here, by three
observers that stay on while the server serves:

* a sampling profiler: a daemon thread reads ``sys._current_frames()``
  ``TRITON_TPU_PROFILE_HZ`` times a second (19 by default, 0 turns it off)
  and folds each thread's stack, by the thread's role, into a window of
  two epochs.  The rate is odd on purpose: a sampler locked in phase with
  a 10 ms batching delay or a 100 Hz timer would always land on (or always
  miss) the same code;
* a lag probe per frontend: a thread that sleeps ``PROBE_INTERVAL_S`` and
  records how late it wakes.  The port's frontends are threads, not an
  event loop, so the overshoot is the wait for the interpreter lock and
  the scheduler that every request thread pays at that moment;
* garbage-collection pauses per generation, from ``gc.callbacks``.

All three reach ``metric_rows()`` (the ``nv_host_*`` families of
``/metrics``), ``snapshot()`` (``/v2/debug/profile?format=json`` and the
incident bundles) and ``collapsed()`` (collapsed-stack text for a
flamegraph, ``/v2/debug/profile``).

Memory is bounded: an epoch keeps at most ``max_stacks`` distinct stacks
and folds the rest into one ``~overflow`` frame; the window rotates every
``window_s``, so ``collapsed()`` covers one to two windows.

Where the port differs from the reference:

* ``classify_thread`` gives the reference's role for every name the
  reference knows, and also knows the port's own threads: ``http.server``'s
  request threads and ``tc-torch-http`` are the frontend, ``batcher-<m>``
  and its ``batch-<m>`` executors the batcher, ``oai-choice-*`` the
  frontend;
* ``install_loop_probe(name)`` starts a probe thread (the reference
  schedules a callback on an asyncio loop);
* ``boost`` wakes the sampler, so a capture window is sampled at its rate
  from its first moment (the reference's sampler sleeps out its base
  period first).
"""

from __future__ import annotations

import gc
import os
import sys
import threading
import time
import traceback
from collections import Counter, deque
from typing import Any, Dict, List, Optional, Tuple

PROFILE_HZ_ENV = "TRITON_TPU_PROFILE_HZ"
DEFAULT_PROFILE_HZ = 19.0

#: distinct folded stacks one epoch keeps; more fold into "~overflow"
DEFAULT_MAX_STACKS = 2048
#: one epoch of the rolling window, in seconds
DEFAULT_WINDOW_S = 60.0
#: frames kept per sample; a deeper stack loses its leaf end
MAX_STACK_DEPTH = 64
#: how often a lag probe wakes, and the samples it keeps
PROBE_INTERVAL_S = 0.25
_PROBE_KEEP = 512


def profile_hz_from_env(default: float = DEFAULT_PROFILE_HZ) -> float:
    """The sampler's rate from ``TRITON_TPU_PROFILE_HZ`` (0: off; a value
    that is not a number gives ``default``)."""
    raw = os.environ.get(PROFILE_HZ_ENV, "")
    if not raw:
        return default
    try:
        return max(0.0, float(raw))
    except ValueError:
        return default


def classify_thread(name: str) -> str:
    """The serving role of a thread, by its name: ``frontend`` (threads
    that answer requests), ``decode`` (a model's decode worker),
    ``readback`` (device-to-host copies), ``batcher`` (where batches
    execute) or ``other``."""
    # the reference's names first, with the reference's answers
    if "-decode-worker" in name:
        return "decode"
    if "-readback" in name or "-gen" in name:
        return "readback"
    if name == "MainThread" or name.startswith("tc-tpu-server"):
        return "frontend"
    if name.startswith("asyncio_") or "ThreadPoolExecutor" in name:
        return "batcher"
    # then the port's own threads
    if (name.endswith("(process_request_thread)")
            or name in ("tc-torch-http", "tc-torch-grpc",
                        "tc-torch-h2-call")
            or name.startswith("oai-choice-")):
        return "frontend"
    if name.startswith(("batcher-", "batch-")):
        return "batcher"
    return "other"


def fold_stack(frame, limit: int = MAX_STACK_DEPTH) -> str:
    """A frame chain as ``file:func;file:func``, the root first (the
    collapsed-stack form of a flamegraph)."""
    parts: List[str] = []
    while frame is not None and len(parts) < limit:
        code = frame.f_code
        parts.append(f"{os.path.basename(code.co_filename)}:{code.co_name}")
        frame = frame.f_back
    parts.reverse()
    return ";".join(parts)


def dump_threads() -> str:
    """Every thread's stack as text, each headed by its name and role.
    Plain Python: ``faulthandler`` writes only to a descriptor given to it
    in advance, and a bundle is written from any thread at any time."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: List[str] = []
    for ident, frame in sorted(sys._current_frames().items()):
        name = names.get(ident, "?")
        out.append(f"Thread 0x{ident:x} ({name}) "
                   f"[role={classify_thread(name)}]:")
        out.extend(line.rstrip("\n")
                   for line in traceback.format_stack(frame))
        out.append("")
    return "\n".join(out)


class _Capture:
    """The samples of one capture window, fed by every sample taken while
    it is registered, whatever the epochs do."""

    def __init__(self) -> None:
        self.counts: Counter = Counter()  # (role, stack) -> samples
        self.samples = 0


class HostProfiler:
    """The sampler, the lag probes and the GC accounting of one server.

    ``start()`` registers the GC callback and, where ``hz > 0``, starts
    the sampler thread; :meth:`install_loop_probe` starts a probe per
    frontend; :meth:`stop` removes the callback and joins every thread it
    started."""

    def __init__(self, hz: Optional[float] = None,
                 window_s: float = DEFAULT_WINDOW_S,
                 max_stacks: int = DEFAULT_MAX_STACKS):
        self.hz = profile_hz_from_env() if hz is None else max(0.0, hz)
        self.window_s = window_s
        self.max_stacks = max_stacks
        self._lock = threading.Lock()
        self._stop = threading.Event()
        # set by boost() and stop(): the sampler re-reads its rate at once
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started = False
        # the window: this epoch and the one before
        self._epoch: Counter = Counter()       # (role, stack) -> samples
        self._prev_epoch: Counter = Counter()
        self._epoch_started = time.monotonic()
        self._samples_by_role: Counter = Counter()  # since start, per role
        self._captures: List[_Capture] = []
        self._boost_hz = 0.0
        self._boost_until = 0.0
        # thread names, read again only when the set of threads changed
        self._names: Dict[int, str] = {}
        self._names_key: frozenset = frozenset()
        # name -> {"last_us", "max_us", "samples": [(monotonic, us)]}
        self._loops: Dict[str, Dict[str, Any]] = {}
        self._probes: List[threading.Thread] = []
        # GC: _on_gc runs on whichever thread started a collection, which
        # may hold self._lock (an allocation in snapshot() can collect),
        # so it takes no lock; finished pauses queue here and the readers
        # drain them under the lock
        self._gc_start_ns: Optional[int] = None
        self._gc_pause_ns: Counter = Counter()        # generation -> ns
        self._gc_collections: Counter = Counter()     # generation -> n
        self._gc_events: deque = deque()              # (generation, ns)
        self._gc_registered = False

    # -- lifecycle ---------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self.hz > 0.0

    def start(self) -> None:
        with self._lock:
            if self._started:
                return
            self._started = True
        if not self._gc_registered:
            gc.callbacks.append(self._on_gc)
            self._gc_registered = True
        if self.enabled:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="tc-torch-host-profiler")
            self._thread.start()

    def stop(self) -> None:
        with self._lock:
            self._started = False
            probes, self._probes = self._probes, []
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
        for p in probes:
            p.join(timeout=5.0)
        if self._gc_registered:
            try:
                gc.callbacks.remove(self._on_gc)
            except ValueError:
                pass
            self._gc_registered = False

    def set_hz(self, hz: float) -> None:
        """Change the sampler's rate while serving: 0 ends the sampler's
        thread (the lag probes and the GC accounting go on), a rate above
        0 starts it again where it was started before."""
        with self._lock:
            self.hz = max(0.0, hz)
            old = self._thread
        self._wake.set()
        if old is not None and not self.enabled:
            old.join(timeout=5.0)
            self._thread = None
        with self._lock:
            restart = (self._started and self.enabled
                       and (self._thread is None
                            or not self._thread.is_alive()))
        if restart:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="tc-torch-host-profiler")
            self._thread.start()

    # -- the sampler -------------------------------------------------------
    def _effective_hz(self) -> float:
        if time.monotonic() < self._boost_until:
            return max(self.hz, self._boost_hz)
        return self.hz

    def _run(self) -> None:
        own = threading.get_ident()
        next_at = time.monotonic()
        while not self._stop.is_set():
            hz = self._effective_hz()
            if hz <= 0:
                return  # set_hz(0): the sampler ends
            # samples keep their period whatever one sample costs; a
            # sampler that fell behind starts again from now (no burst)
            now = time.monotonic()
            next_at = max(next_at + 1.0 / hz, now)
            if self._wake.wait(next_at - now):
                self._wake.clear()
                next_at = time.monotonic()
            if self._stop.is_set():
                break
            self._sample_once(exclude={own})

    def _thread_names(self, idents) -> Dict[int, str]:
        key = frozenset(idents)
        if key != self._names_key:
            self._names = {t.ident: t.name for t in threading.enumerate()
                           if t.ident is not None}
            self._names_key = key
        return self._names

    def _sample_once(self, exclude=frozenset()) -> None:
        frames = sys._current_frames()
        names = self._thread_names(frames.keys())
        now = time.monotonic()
        with self._lock:
            if now - self._epoch_started >= self.window_s:
                self._prev_epoch = self._epoch
                self._epoch = Counter()
                self._epoch_started = now
            for ident, frame in frames.items():
                if ident in exclude:
                    continue
                role = classify_thread(names.get(ident, f"tid-{ident}"))
                key = (role, fold_stack(frame))
                # bounded: a new stack beyond the cap counts as overflow
                if (key not in self._epoch
                        and len(self._epoch) >= self.max_stacks):
                    key = (role, "~overflow")
                self._epoch[key] += 1
                self._samples_by_role[role] += 1
                for cap in self._captures:
                    cap.counts[key] += 1
                    cap.samples += 1

    # -- capture windows ---------------------------------------------------
    def boost(self, hz: float, duration_s: float) -> None:
        """Sample at ``hz`` at least for the next ``duration_s`` seconds,
        from now: the sampler is woken to take the rate at once."""
        self._boost_hz = max(self._boost_hz, hz)
        self._boost_until = max(self._boost_until,
                                time.monotonic() + duration_s)
        self._wake.set()

    def capture_window(self, duration_s: float = 1.0,
                       hz: float = 97.0) -> str:
        """Sample at ``hz`` for ``duration_s`` and return that window as
        collapsed-stack text (an incident bundle's ``profile.folded``).

        With the sampler running, the window rides it (boosted); with the
        sampler off (``hz = 0``), the caller's thread samples: a bundle
        must have its profile exactly where profiling was turned off."""
        cap = _Capture()
        t = self._thread
        with self._lock:
            self._captures.append(cap)
        try:
            if t is not None and t.is_alive() and not self._stop.is_set():
                self.boost(hz, duration_s)
                time.sleep(duration_s)
            else:
                own = threading.get_ident()
                deadline = time.monotonic() + duration_s
                period = 1.0 / max(hz, 1.0)
                while time.monotonic() < deadline:
                    self._sample_once(exclude={own})
                    time.sleep(period)
        finally:
            with self._lock:
                if cap in self._captures:
                    self._captures.remove(cap)
        return self._render_collapsed(cap.counts)

    # -- lag probes --------------------------------------------------------
    def install_loop_probe(self, name: str = "frontend",
                           interval_s: float = PROBE_INTERVAL_S) -> None:
        """Start the lag probe ``name``: a thread that sleeps
        ``interval_s`` and records by how much it woke late.  One probe per
        name (a second install of a name does nothing); it runs until
        :meth:`stop`."""
        with self._lock:
            if name in self._loops:
                return
            state = {"last_us": 0.0, "max_us": 0.0, "samples": []}
            self._loops[name] = state
            t = threading.Thread(target=self._probe,
                                 args=(state, interval_s), daemon=True,
                                 name=f"tc-torch-lag-probe-{name}")
            self._probes.append(t)
        t.start()

    def _probe(self, state: Dict[str, Any], interval_s: float) -> None:
        while True:
            expected = time.monotonic() + interval_s
            if self._stop.wait(interval_s):
                return
            # the overshoot: the wait for the interpreter lock after the
            # timed wait ended, and for the scheduler before that
            mono = time.monotonic()
            lag_us = max(0.0, (mono - expected) * 1e6)
            with self._lock:
                state["last_us"] = lag_us
                samples = state["samples"]
                samples.append((mono, lag_us))
                if len(samples) > _PROBE_KEEP:
                    del samples[: len(samples) - _PROBE_KEEP]
                cutoff = mono - self.window_s
                state["max_us"] = max(
                    (us for ts, us in samples if ts >= cutoff),
                    default=lag_us)

    # -- GC accounting -----------------------------------------------------
    def _on_gc(self, phase: str, info: Dict[str, Any]) -> None:
        # one collection at a time runs under the interpreter lock, so one
        # start stamp is enough
        if phase == "start":
            self._gc_start_ns = time.perf_counter_ns()
        elif phase == "stop" and self._gc_start_ns is not None:
            dt = time.perf_counter_ns() - self._gc_start_ns
            self._gc_start_ns = None
            self._gc_events.append((int(info.get("generation", 0)), dt))

    def _drain_gc_events(self) -> None:
        # under self._lock; a collection meanwhile only appends
        while True:
            try:
                gen, dt = self._gc_events.popleft()
            except IndexError:
                break
            self._gc_pause_ns[gen] += dt
            self._gc_collections[gen] += 1

    # -- what it shows -----------------------------------------------------
    @staticmethod
    def _render_collapsed(counts: Counter) -> str:
        lines = [f"{role};{stack} {n}"
                 for (role, stack), n in sorted(counts.items(),
                                                key=lambda kv: -kv[1])]
        return "\n".join(lines) + ("\n" if lines else "")

    def _window(self) -> Counter:
        with self._lock:
            return self._prev_epoch + self._epoch

    def collapsed(self, role: Optional[str] = None) -> str:
        """The window's stacks as collapsed-stack text (``role;frames N``),
        of one role where ``role`` is given."""
        merged = self._window()
        if role is not None:
            merged = Counter({k: v for k, v in merged.items()
                              if k[0] == role})
        return self._render_collapsed(merged)

    def top_stacks(self, n: int = 10,
                   role: Optional[str] = None) -> List[Tuple[str, str, int]]:
        """The ``n`` stacks with most samples in the window, as (role,
        folded stack, samples)."""
        items = [(r, s, c) for (r, s), c in self._window().items()
                 if role is None or r == role]
        items.sort(key=lambda t: -t[2])
        return items[:n]

    def loop_lag(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {name: {"last_us": st["last_us"],
                           "max_us": st["max_us"]}
                    for name, st in self._loops.items()}

    def metric_rows(self) -> Dict[str, List[Tuple[Dict[str, str], float]]]:
        """Rows of the ``nv_host_*`` families (``metrics.py``), by the
        families' short names."""
        with self._lock:
            self._drain_gc_events()
            lag = [({"loop": name}, st["max_us"])
                   for name, st in sorted(self._loops.items())]
            pauses = [({"generation": str(gen)}, ns / 1e3)
                      for gen, ns in sorted(self._gc_pause_ns.items())]
            samples = [({"role": role}, float(n))
                       for role, n in sorted(self._samples_by_role.items())]
        return {"loop_lag": lag, "gc_pause": pauses, "samples": samples}

    def snapshot(self) -> Dict[str, Any]:
        """``/v2/debug/profile?format=json``, and a bundle's
        ``profiler.json``."""
        with self._lock:
            self._drain_gc_events()
            merged = self._prev_epoch + self._epoch
            top = sorted(((r, s, c) for (r, s), c in merged.items()),
                         key=lambda t: -t[2])[:50]
            return {
                "hz": self.hz,
                "enabled": self.enabled,
                "window_s": self.window_s,
                "samples_by_role": dict(self._samples_by_role),
                "distinct_stacks": len(merged),
                "top_stacks": [{"role": r, "stack": s, "samples": c}
                               for r, s, c in top],
                "loop_lag": {
                    name: {"last_us": st["last_us"],
                           "max_us": st["max_us"],
                           "series": [{"ts_mono": ts, "lag_us": us}
                                      for ts, us in st["samples"][-64:]]}
                    for name, st in self._loops.items()},
                "gc": {
                    str(gen): {
                        "pause_us_total": self._gc_pause_ns[gen] / 1e3,
                        "collections": self._gc_collections[gen]}
                    for gen in sorted(self._gc_pause_ns)},
            }
