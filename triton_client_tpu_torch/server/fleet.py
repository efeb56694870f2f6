"""Closed-loop fleet operations: autoscaling, rolling model updates under
traffic, and the self-healing supervisor's restart policy.

The port's copy of ``triton_client_tpu/server/fleet.py``.  Three pieces:

* :class:`FleetController`, the per-core control loop.

  **Autoscaling.**  Each evaluation reads three signals per model: the
  short-window SLO burn rate (``SloEngine.burn_rate``), the queued backlog
  of the model's batchers, and the device duty cycle
  (``DeviceStatsCollector.duty_cycle``).  A burn at or over the engine's
  threshold, or a backlog of ``queue_high`` requests per instance, scales
  OUT by one instance; a duty cycle under ``idle_duty`` with an empty queue
  for ``idle_cycles`` evaluations in a row scales IN by one.  The dead band
  between the two is the hysteresis; ``scale_out_cooldown_s`` and the
  longer ``scale_in_cooldown_s`` rate-limit actuation per model.  Bounds
  come from ``--autoscale MODEL=MIN..MAX`` or the config's
  ``autoscale.min_instances`` / ``autoscale.max_instances`` parameters; a
  model with neither is never touched.  The actuator is
  ``_DynamicBatcher.set_instances``, the number of batches a model's
  batcher executes at once: no scale event drops queued work.

  **Rolling updates.**  :meth:`FleetController.rolling_update` stages a new
  version in the registry (``stage_version``: outside readiness and
  routing), warms it through the real execute path while the old version
  serves, flips the served default (``promote``, one swap under the
  registry's lock), then watches a bake window whose verdict is scoped to
  the new version (:meth:`FleetController._bake_breached`): a breach rolls
  the flip back (``demote``) and retires the new instance; otherwise the
  old version's batcher is drained (its queued work runs on the old
  instance) and the old version stays addressable.

* :class:`RestartPolicy`: the supervisor's crash arithmetic (capped
  exponential backoff, sliding-window storm detection).

* :class:`SupervisorState`: an atomically replaced JSON file the supervisor
  writes restart counts into and the workers read back (its path in
  ``TRITON_TPU_FLEET_STATE``), so ``nv_fleet_worker_restart_total`` shows on
  every worker's metrics port.

Threads: the reference runs the loop and every actuation on its core's
event loop; the port's server serves a request per thread, so the control
loop is a daemon thread that :meth:`FleetController.start` and
:meth:`FleetController.stop` own, and :meth:`FleetController.rolling_update`
blocks its caller.  The counter lock guards dict updates and copies only:
it is never held across a wait, and never nested with another lock.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, Optional, Tuple

from .types import InferError

__all__ = [
    "FleetController",
    "RestartPolicy",
    "SupervisorState",
    "collect_fleet_rows",
    "crash_reason_from_exit",
    "fleet_state_path",
    "parse_autoscale_spec",
    "worker_crash_reasons",
    "worker_restart_counts",
]

#: the supervisor's state file (restart counters)
FLEET_STATE_ENV = "TRITON_TPU_FLEET_STATE"
#: the directory of the shared-memory manifest that the supervisor gives
#: its workers (shm.py)
MANIFEST_ENV = "TRITON_TPU_SHM_MANIFEST"

#: a bound that a spec or a config leaves out
DEFAULT_MIN_INSTANCES = 1
DEFAULT_MAX_INSTANCES = 8

#: the short burn window that drives scale-out
SHORT_BURN_WINDOW_S = 300.0


def parse_autoscale_spec(spec: str) -> Tuple[str, Tuple[int, int]]:
    """``--autoscale MODEL=MIN..MAX`` -> (model, (min, max)).  ``MIN..``
    and ``..MAX`` leave the other bound at its default.  A ValueError on
    junk, so that a typo fails at start-up."""
    name, sep, rest = spec.partition("=")
    if not sep or not name or not rest:
        raise ValueError(
            f"invalid --autoscale '{spec}': expected MODEL=MIN..MAX")
    lo_s, sep, hi_s = rest.partition("..")
    if not sep:
        raise ValueError(
            f"invalid --autoscale '{spec}': expected MODEL=MIN..MAX")
    try:
        lo = int(lo_s) if lo_s else DEFAULT_MIN_INSTANCES
        hi = int(hi_s) if hi_s else DEFAULT_MAX_INSTANCES
    except ValueError:
        raise ValueError(
            f"invalid --autoscale '{spec}': MIN/MAX must be integers")
    if lo < 1 or hi < lo:
        raise ValueError(
            f"invalid --autoscale '{spec}': need 1 <= MIN <= MAX")
    return name, (lo, hi)


class RestartPolicy:
    """Crash bookkeeping for one supervised worker.

    :meth:`on_crash` returns the delay (seconds) before the restart, or
    None when the crash is part of a storm (``storm_limit`` crashes inside
    the sliding ``window_s``) and the supervisor should fail fast.  The
    backoff's exponent is the number of crashes still inside the window, so
    a worker that stays up long enough earns its fast first restart back."""

    def __init__(self, base_delay_s: float = 0.5, max_delay_s: float = 30.0,
                 storm_limit: int = 5, window_s: float = 30.0):
        if storm_limit < 1:
            raise ValueError("storm_limit must be >= 1")
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.storm_limit = int(storm_limit)
        self.window_s = float(window_s)
        self._crashes: deque = deque()

    def recent_crashes(self, now: Optional[float] = None) -> int:
        now = time.monotonic() if now is None else now
        while self._crashes and self._crashes[0] < now - self.window_s:
            self._crashes.popleft()
        return len(self._crashes)

    def on_crash(self, now: Optional[float] = None) -> Optional[float]:
        now = time.monotonic() if now is None else now
        self.recent_crashes(now)  # prune the window
        self._crashes.append(now)
        n = len(self._crashes)
        if n >= self.storm_limit:
            return None  # a crash storm: restarting would hot-loop
        return min(self.max_delay_s, self.base_delay_s * (2.0 ** (n - 1)))


class SupervisorState:
    """The JSON state file the supervisor shares with its workers.

    The supervisor serves no port, so restart counters ride this file:
    :meth:`record_restart` rewrites it atomically (a temporary file, then
    ``os.replace``) and each worker's metrics read it back
    (:func:`worker_restart_counts`)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._restarts: Dict[str, int] = {}
        self._reasons: Dict[str, str] = {}

    def record_restart(self, worker: str,
                       reason: Optional[str] = None) -> int:
        """Count a restart and, where given, the reason the worker died
        (``crash_reasons`` keeps the last one per worker)."""
        with self._lock:
            self._restarts[worker] = self._restarts.get(worker, 0) + 1
            if reason:
                self._reasons[worker] = reason
            snapshot = dict(self._restarts)
            reasons = dict(self._reasons)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"worker_restarts": snapshot,
                       "crash_reasons": reasons}, f)
        os.replace(tmp, self.path)
        return snapshot[worker]

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._restarts)

    def reasons(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._reasons)


# (path, mtime_ns) -> (counts, reasons): each /metrics scrape reads the
# file, which changes only when a worker restarted
_state_cache: Tuple[Optional[Tuple[str, int]], Dict[str, int],
                    Dict[str, str]] = (None, {}, {})
_state_cache_lock = threading.Lock()


def fleet_state_path() -> Optional[str]:
    """The supervisor's state file, or None for an unsupervised process."""
    return os.environ.get(FLEET_STATE_ENV) or None


def _read_state(path: Optional[str]) -> Tuple[Dict[str, int],
                                              Dict[str, str]]:
    global _state_cache
    path = path if path is not None else os.environ.get(FLEET_STATE_ENV)
    if not path:
        return {}, {}
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        return {}, {}
    key = (path, mtime)
    with _state_cache_lock:
        if _state_cache[0] == key:
            return dict(_state_cache[1]), dict(_state_cache[2])
    try:
        with open(path) as f:
            data = json.load(f)
        counts = {str(k): int(v)
                  for k, v in (data.get("worker_restarts") or {}).items()}
        reasons = {str(k): str(v)
                   for k, v in (data.get("crash_reasons") or {}).items()}
    except (OSError, ValueError):
        return {}, {}
    with _state_cache_lock:
        _state_cache = (key, counts, reasons)
    return dict(counts), dict(reasons)


def worker_restart_counts(path: Optional[str] = None) -> Dict[str, int]:
    """Restart counters from the supervisor's state file (the
    ``TRITON_TPU_FLEET_STATE`` file where ``path`` is None); empty where
    it is unset, absent or unreadable."""
    return _read_state(path)[0]


def worker_crash_reasons(path: Optional[str] = None) -> Dict[str, str]:
    """The last crash reason per worker from the same file."""
    return _read_state(path)[1]


def crash_reason_from_exit(returncode: Optional[int]) -> str:
    """A crash reason from a ``Popen.returncode``: a signal's name for a
    negative code, ``chaos:worker_kill`` for exit code 70 (what a CLI
    worker's ``worker_kill`` callback exits with), else the code."""
    if returncode is None:
        return "unknown"
    if returncode < 0:
        import signal as _signal

        try:
            return f"signal:{_signal.Signals(-returncode).name}"
        except ValueError:
            return f"signal:{-returncode}"
    if returncode == 70:
        return "chaos:worker_kill"
    return f"exit:{returncode}"


class FleetController:
    """The closed loop of one :class:`InferenceCore`: per-model instance
    autoscaling and rolling version updates.

    Construct, assign to ``core.fleet``, and either call :meth:`evaluate`
    (tests: an injectable ``now`` and replaceable signal readers) or
    :meth:`start` the loop's thread."""

    def __init__(self, core, interval_s: float = 1.0,
                 bounds: Optional[Dict[str, Tuple[int, int]]] = None,
                 queue_high: float = 4.0,
                 idle_duty: float = 0.05,
                 idle_cycles: int = 5,
                 scale_out_cooldown_s: float = 5.0,
                 scale_in_cooldown_s: float = 30.0,
                 bake_s: float = 10.0,
                 bake_min_samples: int = 8,
                 bake_fail_fraction: float = 0.5,
                 bake_latency_factor: float = 2.0):
        if interval_s <= 0:
            raise ValueError("interval_s must be positive")
        self._core = core
        self.interval_s = float(interval_s)
        #: explicit CLI bounds; config parameters fill the rest
        self.bounds: Dict[str, Tuple[int, int]] = dict(bounds or {})
        self.queue_high = float(queue_high)
        self.idle_duty = float(idle_duty)
        self.idle_cycles = int(idle_cycles)
        self.scale_out_cooldown_s = float(scale_out_cooldown_s)
        self.scale_in_cooldown_s = float(scale_in_cooldown_s)
        self.bake_s = float(bake_s)
        self.bake_min_samples = int(bake_min_samples)
        self.bake_fail_fraction = float(bake_fail_fraction)
        self.bake_latency_factor = float(bake_latency_factor)
        self._thread: Optional[threading.Thread] = None
        # set by stop(): the loop's thread and every bake in progress end
        self._stop = threading.Event()
        # the counter lock: the loop's thread, rolling updates and scrape
        # threads.  Held for dict updates and copies only
        self._lock = threading.Lock()
        self._desired: Dict[str, int] = {}
        self._last_out: Dict[str, float] = {}
        self._last_in: Dict[str, float] = {}
        self._idle_streak: Dict[str, int] = {}
        # (model, direction) -> actuations; direction out or in
        self.scale_events: Dict[Tuple[str, str], int] = {}
        # (model, outcome) -> count: completed, rolled_back, warmup_failed
        # (and device_fault_escalated)
        self.update_events: Dict[Tuple[str, str], int] = {}
        #: models inside a rolling update (its bake included)
        self._updating: set = set()
        # a quarantined model whose probes keep failing calls back here:
        # more instances would share the same sick card, so the escalation
        # is counted on the fleet's metrics and the restart is left to the
        # supervisor or the operator.  A later writer of escalation_cb wins
        faults = getattr(core, "device_faults", None)
        if faults is not None and faults.escalation_cb is None:
            faults.escalation_cb = self._on_fault_escalation

    def _on_fault_escalation(self, name: str, state: Dict) -> None:
        """The default escalation hook (called from a probe's thread):
        ``nv_fleet_rolling_update_total{outcome="device_fault_escalated"}``."""
        with self._lock:
            key = (name, "device_fault_escalated")
            self.update_events[key] = self.update_events.get(key, 0) + 1

    # -- bounds and the desired state ----------------------------------------
    def _config_bounds(self, name: str) -> Optional[Tuple[int, int]]:
        """Bounds from the config's ``autoscale.min_instances`` /
        ``autoscale.max_instances`` parameters (either alone enables
        autoscaling, the other at its default); None where it declares
        neither or the values are junk."""
        try:
            model = self._core.registry.get(name)
        except InferError:
            return None
        params = model.config.parameters
        lo_s = params.get("autoscale.min_instances")
        hi_s = params.get("autoscale.max_instances")
        if lo_s is None and hi_s is None:
            return None
        try:
            lo = int(lo_s) if lo_s is not None else DEFAULT_MIN_INSTANCES
            hi = int(hi_s) if hi_s is not None else DEFAULT_MAX_INSTANCES
        except ValueError:
            return None
        if lo < 1 or hi < lo:
            return None
        return (lo, hi)

    def bounds_for(self, name: str) -> Optional[Tuple[int, int]]:
        """The model's (min, max) instances: the CLI's bounds, else the
        config's; None: not autoscaled."""
        explicit = self.bounds.get(name)
        if explicit is not None:
            return explicit
        return self._config_bounds(name)

    def desired_instances(self, name: str) -> Optional[int]:
        """The controller's target for ``name`` (None where the model is
        not autoscaled).  A new batcher starts at it, so a scaled model
        keeps its scale across a reload."""
        bounds = self.bounds_for(name)
        if bounds is None:
            return None
        with self._lock:
            desired = self._desired.get(name)
        if desired is None:
            # first sighting: the batcher's static default, clamped into
            # the bounds
            from .core import _DynamicBatcher

            desired = min(max(_DynamicBatcher.MAX_INFLIGHT, bounds[0]),
                          bounds[1])
            with self._lock:
                desired = self._desired.setdefault(name, desired)
        return desired

    # -- signals -------------------------------------------------------------
    def _batchers_for(self, name: str):
        prefix = f"{name}@"
        with self._core._lock:
            items = list(self._core._batchers.items())
        return [b for key, b in items if key.startswith(prefix)]

    def queue_depth(self, name: str) -> int:
        """The queued backlog of the model's batchers (every served
        version)."""
        return sum(b._queue.qsize() for b in self._batchers_for(name))

    def live_instances(self, name: str) -> int:
        return sum(b.instances for b in self._batchers_for(name))

    def burn(self, name: str, now: Optional[float] = None) -> Optional[float]:
        """The short-window burn rate: the scale-out pressure."""
        return self._core.slo.burn_rate(name, SHORT_BURN_WINDOW_S, now)

    def duty(self, name: str, now: Optional[float] = None) -> Optional[float]:
        return self._core.device_stats.duty_cycle(name, now)

    # -- actuation -----------------------------------------------------------
    def scale_to(self, name: str, n: int, direction: Optional[str] = None,
                 now: Optional[float] = None) -> int:
        """Set the model's target (clamped to its bounds) and apply it to
        every live batcher of the model."""
        bounds = self.bounds_for(name) or (1, max(1, n))
        n = min(max(int(n), bounds[0]), bounds[1])
        now = time.monotonic() if now is None else now
        with self._lock:
            prev = self._desired.get(name)
            self._desired[name] = n
            if direction is not None and n != prev:
                key = (name, direction)
                self.scale_events[key] = self.scale_events.get(key, 0) + 1
                if direction == "out":
                    self._last_out[name] = now
                else:
                    self._last_in[name] = now
        for b in self._batchers_for(name):
            b.set_instances(n)
        return n

    def evaluate(self, now: Optional[float] = None) -> None:
        """One pass of the loop over every autoscaled model: reads of the
        SLO windows, the batchers' lanes and the duty cycle."""
        now = time.monotonic() if now is None else now
        # the due quarantine probes start here, each on a thread of its own
        self._core.device_faults.maybe_probe(now)
        for model in self._core.registry.ready_models():
            name = model.name
            bounds = self.bounds_for(name)
            if bounds is None:
                continue
            lo, hi = bounds
            if self._core.device_faults.is_quarantined(name):
                # nothing is admitted: hold the target, and above all never
                # scale in on that idleness
                with self._lock:
                    self._idle_streak[name] = 0
                continue
            desired = self.desired_instances(name) or lo
            if desired < lo or desired > hi:
                # the bounds narrowed: converge at once
                desired = self.scale_to(
                    name, desired,
                    direction=("in" if desired > hi else "out"), now=now)
                continue
            depth = self.queue_depth(name)
            burn = self.burn(name, now)
            breach = (burn is not None
                      and burn >= self._core.slo.burn_threshold)
            backlog = depth >= self.queue_high * max(1, desired)
            if breach or backlog:
                with self._lock:
                    self._idle_streak[name] = 0
                    last = self._last_out.get(name, -1e9)
                if desired < hi and now - last >= self.scale_out_cooldown_s:
                    self.scale_to(name, desired + 1, direction="out",
                                  now=now)
                continue
            duty = self.duty(name, now)
            idle = (depth == 0 and duty is not None
                    and duty < self.idle_duty)
            with self._lock:
                streak = self._idle_streak.get(name, 0) + 1 if idle else 0
                self._idle_streak[name] = streak
                last = self._last_in.get(name, -1e9)
            if (idle and streak >= self.idle_cycles and desired > lo
                    and now - last >= self.scale_in_cooldown_s):
                self.scale_to(name, desired - 1, direction="in", now=now)

    # -- the loop's thread ---------------------------------------------------
    @property
    def running(self) -> bool:
        """Whether the loop's thread runs (it then drives the quarantine
        probes in place of the core's prober)."""
        t = self._thread
        return t is not None and t.is_alive() and not self._stop.is_set()

    def start(self) -> None:
        """Start the loop's daemon thread: :meth:`evaluate` every
        ``interval_s``."""
        if self.running:
            return
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(self._stop,), daemon=True,
            name="tc-torch-fleet")
        self._thread.start()

    def stop(self, timeout_s: float = 10.0) -> None:
        """Stop the loop's thread, and end every bake in progress without
        an outcome (the flip stays: it is valid registry state); waits up
        to ``timeout_s`` for both."""
        self._stop.set()
        end = time.monotonic() + max(0.0, timeout_s)
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=max(0.0, end - time.monotonic()))
        self._thread = None
        while time.monotonic() < end:
            with self._lock:
                if not self._updating:
                    break
            time.sleep(0.01)

    def _run(self, stop: threading.Event) -> None:
        while not stop.wait(self.interval_s):
            try:
                self.evaluate()
            except Exception:  # noqa: BLE001 - the loop must survive a
                # registry or model surprise; the next pass reads afresh
                pass

    # -- rolling updates -----------------------------------------------------
    def _count_update(self, name: str, outcome: str) -> None:
        with self._lock:
            key = (name, outcome)
            self.update_events[key] = self.update_events.get(key, 0) + 1

    def _bake_breached(self, name: str, model, baseline_breached: bool,
                       base_success: int, base_fail: int,
                       base_success_ns: int) -> bool:
        """The rollback verdict of the bake window, scoped to the new
        version: the burn crosses the threshold where it did not at the
        flip; the new instance's failures reach ``bake_fail_fraction`` of
        at least ``bake_min_samples``; or, under an SLO objective, its mean
        request time exceeds ``bake_latency_factor`` x the p99 target."""
        if not baseline_breached:
            burn = self.burn(name)
            if burn is not None and burn >= self._core.slo.burn_threshold:
                return True
        with model.stats.lock:
            fails = model.stats.fail_count - base_fail
            succ = model.stats.success_count - base_success
            succ_ns = model.stats.success_ns - base_success_ns
        total = fails + succ
        if total >= self.bake_min_samples \
                and fails / total >= self.bake_fail_fraction:
            return True
        obj = self._core.slo.objective_for(name)
        if obj is not None and succ >= self.bake_min_samples:
            mean_ms = succ_ns / succ / 1e6
            if mean_ms > obj.p99_ms * self.bake_latency_factor:
                return True
        return False

    def _stopped(self, name: str) -> InferError:
        return InferError(
            f"rolling update of '{name}' ended: the fleet controller "
            "stopped", http_status=503)

    def rolling_update(self, name: str, model,
                       version: Optional[str] = None,
                       bake_s: Optional[float] = None,
                       drain_timeout_s: float = 30.0) -> str:
        """Load ``model`` as a new version of ``name`` under live traffic:
        stage, warm, flip, bake, then commit (the old batcher drained; the
        old version stays addressable) or roll back.  Blocks its caller;
        returns ``"completed"`` or ``"rolled_back"``.  Raises where staging
        or warmup fails (the old version never stopped serving), and where
        :meth:`stop` ends the bake.  One update per model at a time."""
        core = self._core
        registry = core.registry
        old_default = registry.get(name)
        old_version = old_default.served_version
        if version is None:
            version = str(max((int(v) for v in old_default.versions),
                              default=0) + 1)
        stop = self._stop
        with self._lock:
            if name in self._updating:
                raise InferError(
                    f"a rolling update for '{name}' is already in "
                    "progress", http_status=409)
            self._updating.add(name)
        try:
            registry.stage_version(name, model, version)
            try:
                # warm through the real execute path: the flip must not
                # expose a version whose first request builds its weights
                core._warmup_one(model)
            except Exception as e:  # noqa: BLE001 - a failed update
                registry.abort_stage(name, version)
                try:
                    # a partial warmup may have placed weights on the card
                    model.unload()
                except Exception:  # noqa: BLE001 - best-effort free
                    pass
                self._count_update(name, "warmup_failed")
                raise InferError(
                    f"rolling update of '{name}' to version {version} "
                    f"failed during warmup: {e}", http_status=400)
            if stop.is_set():
                registry.abort_stage(name, version)
                raise self._stopped(name)
            with model.stats.lock:
                base_success = model.stats.success_count
                base_fail = model.stats.fail_count
                base_success_ns = model.stats.success_ns
            # a model already burning at the flip must not veto a healthy
            # update through its own history
            baseline_burn = self.burn(name)
            baseline_breached = (
                baseline_burn is not None
                and baseline_burn >= self._core.slo.burn_threshold)
            # THE FLIP: unversioned requests resolve the new instance from
            # here on; requests that resolved the old one finish on it
            registry.promote(name, version)
            core.slo.invalidate(name)
            core.device_stats.forget_model(name)
            core.retire_wire_templates(name)
            core.log.info(f"rolling update: '{name}' now serving version "
                          f"{version} (was {old_version}); baking")
            bake_s = self.bake_s if bake_s is None else float(bake_s)
            deadline = time.monotonic() + max(0.0, bake_s)
            poll = min(0.05, self.interval_s)
            while time.monotonic() < deadline:
                if stop.wait(poll):
                    raise self._stopped(name)
                if self._bake_breached(name, model, baseline_breached,
                                       base_success, base_fail,
                                       base_success_ns):
                    # ROLLBACK: the default returns to the old instance,
                    # what the new one admitted drains, then it retires
                    registry.demote(name, version, fallback=old_version)
                    core.slo.invalidate(name)
                    core.retire_wire_templates(name)
                    core.drain_batcher(name, version,
                                       timeout_s=drain_timeout_s)
                    try:
                        model.unload()
                    except Exception:  # noqa: BLE001 - best-effort free
                        pass
                    self._count_update(name, "rolled_back")
                    core.log.error(
                        f"rolling update: '{name}' version {version} "
                        f"breached during bake — rolled back to "
                        f"{old_version}")
                    return "rolled_back"
            # COMMIT: the old default's queued work runs on the old
            # instance, then its batcher retires; the old version stays
            # served and addressable
            core.drain_batcher(name, old_version, timeout_s=drain_timeout_s)
            self._count_update(name, "completed")
            return "completed"
        finally:
            with self._lock:
                self._updating.discard(name)

    # -- export --------------------------------------------------------------
    def metric_rows(self) -> Dict[str, list]:
        """The controller's rows, keyed by the short names
        ``metrics.collect_families`` declares."""
        with self._lock:
            scale = dict(self.scale_events)
            updates = dict(self.update_events)
        rows: Dict[str, list] = {"scale": [], "rolling_update": []}
        for (model, direction), n in sorted(scale.items()):
            rows["scale"].append(
                ({"model": model, "direction": direction}, n))
        for (model, outcome), n in sorted(updates.items()):
            rows["rolling_update"].append(
                ({"model": model, "outcome": outcome}, n))
        return rows


def collect_fleet_rows(core) -> Dict[str, list]:
    """Every ``nv_fleet_*`` row, with or without a controller: the live
    instances and the served version from the batchers and the registry,
    the actuation and update counters from ``core.fleet``, the worker
    restarts from the supervisor's state file."""
    rows: Dict[str, list] = {"instances": [], "serving_version": [],
                             "scale": [], "rolling_update": [],
                             "worker_restart": []}
    instances: Dict[str, int] = {}
    with core._lock:
        batchers = list(core._batchers.items())
    for key, b in batchers:
        name = key.rsplit("@", 1)[0]
        instances[name] = instances.get(name, 0) + b.instances
    for name, n in sorted(instances.items()):
        rows["instances"].append(({"model": name}, n))
    for model in core.registry.ready_models():
        try:
            v = int(model.served_version)
        except (TypeError, ValueError):
            continue  # a version that is not a number has no gauge
        rows["serving_version"].append(({"model": model.name}, v))
    fleet = getattr(core, "fleet", None)
    if fleet is not None:
        rows.update(fleet.metric_rows())
    rows["worker_restart"] = [
        ({"worker": worker}, n)
        for worker, n in sorted(worker_restart_counts().items())]
    return rows
