"""Server-side request tracing behind the ``/v2/trace/setting`` API.

The port's copy of ``triton_client_tpu/server/trace.py``: the same settings,
sampling, record format and file rotation, so the reference's
``tools.trace_summary`` reads the port's trace files.  ``RequestTracer``
samples requests at ``trace_rate`` (and within ``trace_count``), per model
where a model has its own settings, and appends one JSON object per traced
request to ``trace_file``:

    {"id": 7, "model_name": "simple", "model_version": "1",
     "timestamps": [{"name": "REQUEST_START", "ns": ...}, ...],
     "spans": [{"name": "REQUEST", "start_ns": ..., "end_ns": ...,
                "parent": null},
               {"name": "COMPUTE", "start_ns": ..., "end_ns": ...,
                "parent": "REQUEST"}, ...]}

The root span is ``REQUEST``; its children are among DECODE, QUEUE,
BATCH_ASSEMBLY, COMPUTE, D2H_TRANSFER, SERIALIZE and NETWORK_WRITE.  The
reference's H2D_TRANSFER marks its cross-process shared-memory staging
copy; the port maps such a region with cudaIPC and copies nothing, so no
span of that name is made.  ``log_frequency`` > 0 rotates the file into
``<trace_file>.0``, ``<trace_file>.1``, ... with that many traces each.

``trace_level``:

* ``OFF`` -- no tracing (the default);
* ``TIMESTAMPS`` -- per-request timelines into ``trace_file``;
* ``TENSORS`` -- refused at update time (HTTP 501 / gRPC UNIMPLEMENTED),
  with the reference's text;
* ``PROFILE`` -- while set, a ``torch.profiler`` window (CPU and, where
  there is a card, CUDA activities) is open, and when it is turned off the
  window's Chrome trace is written into ``<trace_file>.profile/``.  The
  window runs on a thread of its own, so it starts and stops on one thread
  whichever request threads set and clear the level.

Timestamps are ``time.monotonic_ns()``, the clock of the requests'
``arrival_ns`` and of the statistics, so trace entries line up with
``/v2/models/*/stats``.

The port serves each request on a thread of its own and executes batches
on a pool (the reference: tasks on one event loop), so a request's
context travels with it: in the batcher's queue item to the executing
thread, and as :func:`current_trace` on each thread that works for it.

Every record carries ``replica`` where the process has a name
(``RequestTracer.replica``) and, where ``otlp`` holds an exporter
(``InferenceCore.enable_otlp``), is also submitted to it as it is written
(the reference's, trace.py:452-459 and :668-672).
"""

from __future__ import annotations

import contextvars
import json
import os
import threading
import time
from typing import Dict, List, Optional

from .._telemetry import AppendFile
from .types import InferError

_KNOWN_LEVELS = {"OFF", "TIMESTAMPS", "TENSORS", "PROFILE"}


def token_event_stride(default: int = 8) -> int:
    """``TRITON_TPU_TRACE_TOKEN_STRIDE``: every Nth chunk of a traced
    stream gets a ``TOKEN[n]`` timestamp (the first stamps
    ``FIRST_TOKEN``); junk or non-positive values give the default."""
    try:
        n = int(os.environ.get("TRITON_TPU_TRACE_TOKEN_STRIDE", default))
    except ValueError:
        return default
    return n if n > 0 else default


#: a stream record keeps this many decode ticks (the first ones) and counts
#: the rest in ``ticks_dropped``
MAX_TICKS_PER_STREAM = 512


#: the trace context of the request this thread is working for
_CURRENT_TRACE: "contextvars.ContextVar[Optional[TraceContext]]" = \
    contextvars.ContextVar("triton_torch_current_trace", default=None)


def current_trace() -> Optional["TraceContext"]:
    """The TraceContext of the request served on this thread, where it is
    traced (or armed for the flight recorder); None otherwise."""
    return _CURRENT_TRACE.get()


def set_current_trace(ctx: Optional["TraceContext"]):
    return _CURRENT_TRACE.set(ctx)


def reset_current_trace(token) -> None:
    _CURRENT_TRACE.reset(token)


#: server defaults: a ``null`` / empty update value clears a key to these
TRACE_DEFAULTS: Dict[str, List[str]] = {
    "trace_file": ["trace.json"],
    "trace_level": ["OFF"],
    "trace_rate": ["1000"],
    "trace_count": ["-1"],
    "log_frequency": ["0"],
}


def validate_trace_update(settings: Dict[str, List[str]],
                          model_scope: bool = False) -> None:
    """Refuse unsupported trace settings before they are applied: 501 for
    ``trace_level`` TENSORS, 400 for unknown keys or levels, non-numeric
    numbers, a rate under 1, and PROFILE in a model's scope (the profiler
    is process-wide)."""
    for key, vals in settings.items():
        if key not in TRACE_DEFAULTS:
            raise InferError(f"unknown trace setting '{key}'", http_status=400)
        if not isinstance(vals, list) or not all(isinstance(v, str)
                                                 for v in vals):
            raise InferError(
                f"trace setting '{key}' expects a list of strings",
                http_status=400)
    levels = settings.get("trace_level")
    if levels is not None:
        for lvl in levels:
            if lvl not in _KNOWN_LEVELS:
                raise InferError(f"unknown trace_level '{lvl}'",
                                 http_status=400)
        if "TENSORS" in levels:
            # the reference's status and text, word for word
            raise InferError(
                "trace_level TENSORS is not implemented on the TPU path "
                "(tensor capture would force a per-request device->host "
                "copy); use TIMESTAMPS and/or PROFILE",
                http_status=501)
        if model_scope and "PROFILE" in levels:
            raise InferError(
                "trace_level PROFILE is process-global (torch profiler); set "
                "it on the global trace settings, not per model",
                http_status=400)
    for key in ("trace_rate", "trace_count", "log_frequency"):
        vals = settings.get(key)
        if vals is not None:
            try:
                ival = int(vals[0])
            except (TypeError, ValueError, IndexError):
                raise InferError(
                    f"trace setting '{key}' expects an integer",
                    http_status=400)
            if key == "trace_rate" and ival <= 0:
                raise InferError("trace_rate must be positive",
                                 http_status=400)


class Span:
    """One interval of a traced request's span tree.  ``end()`` may run on
    another thread than the one that opened it; attribute stores are
    atomic under the interpreter lock."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "attrs")

    def __init__(self, name: str, start_ns: int,
                 parent: Optional[str] = "REQUEST") -> None:
        self.name = name
        self.start_ns = int(start_ns)
        self.end_ns: Optional[int] = None
        self.parent = parent
        # attributes (a PREFILL span's ``cached_tokens``), written as
        # "attrs" on the span's record only when set
        self.attrs: Optional[Dict[str, object]] = None

    def end(self, ns: Optional[int] = None) -> None:
        self.end_ns = int(ns if ns is not None else time.monotonic_ns())

    def set_attr(self, key: str, value) -> None:
        attrs = self.attrs
        if attrs is None:
            attrs = self.attrs = {}
        attrs[key] = value


class TraceContext:
    """One traced request: its timestamps and span tree, written when it is
    emitted.  ``path`` is the trace file of the scope that sampled it.  A
    shadow context (``sampled`` False) collects spans for the flight
    recorder only and never reaches the file."""

    __slots__ = ("_tracer", "id", "model_name", "model_version",
                 "timestamps", "path", "client_request_id", "traceparent",
                 "spans", "log_frequency", "_root", "_done", "sampled",
                 "flight", "tick", "outcome", "cost")

    def __init__(self, tracer: "RequestTracer", trace_id: int,
                 model_name: str, model_version: str, path: str,
                 client_request_id: str = "", traceparent: str = "",
                 log_frequency: int = 0) -> None:
        self._tracer = tracer
        self.id = trace_id
        self.model_name = model_name
        self.model_version = model_version
        self.timestamps: List[Dict[str, int]] = []
        self.path = path
        self.client_request_id = client_request_id
        self.traceparent = traceparent
        self.spans: List[Span] = []
        self.log_frequency = log_frequency
        self._root: Optional[Span] = None
        self._done = False
        self.sampled = True
        # the request's FlightRecord where the flight recorder is on
        self.flight = None
        # the batcher tick this request rode (device_stats)
        self.tick = None
        # "ok", or the first failure's message
        self.outcome = "ok"
        # the request's share of its batch's compute window (costs.py)
        self.cost = None

    def ts(self, name: str, ns: Optional[int] = None) -> None:
        if not self.sampled:
            return
        self.timestamps.append(
            {"name": name,
             "ns": int(ns if ns is not None else time.monotonic_ns())})

    # -- span tree ---------------------------------------------------------
    def begin_root(self, start_ns: int) -> Span:
        """Open the REQUEST root span; every later span nests inside it."""
        self._root = Span("REQUEST", start_ns, parent=None)
        self.spans.append(self._root)
        return self._root

    def add_span(self, name: str, start_ns: int, end_ns: int,
                 parent: Optional[str] = "REQUEST") -> Span:
        span = Span(name, start_ns, parent)
        span.end(end_ns)
        self.spans.append(span)
        return span

    def finish(self) -> None:
        """Close the REQUEST envelope (timestamp and root span), once."""
        if self._done:
            return
        self._done = True
        now = time.monotonic_ns()
        self.ts("REQUEST_END", now)
        if self._root is not None and self._root.end_ns is None:
            self._root.end(now)

    def mark_failed(self, exc: BaseException) -> None:
        """Stamp the outcome (and the flight record's) from the first
        failure."""
        msg = str(exc) or type(exc).__name__
        if self.outcome == "ok":
            self.outcome = msg
        rec = self.flight
        if rec is not None and rec.outcome == "ok":
            rec.outcome = msg

    def mark_cancelled(self) -> None:
        """The consumer closed the stream: the trace record says so, the
        flight record's outcome stays "ok" (the request was served as far
        as the client wanted)."""
        if self.outcome == "ok":
            self.outcome = "cancelled"

    def emit(self) -> None:
        """Close the envelope, append the record to the trace file (sampled
        contexts only) and hand the request to the flight recorder."""
        self.finish()
        if self.sampled:
            self._tracer._emit(self)
        rec, self.flight = self.flight, None
        if rec is not None:
            recorder = self._tracer.flight_recorder
            if recorder is not None:
                recorder.complete(rec, self)


class StreamTraceContext(TraceContext):
    """One traced decoupled stream: open across the whole stream, with a
    strided token timeline (``FIRST_TOKEN``, then ``TOKEN[n]`` every
    ``token_event_stride()`` chunks) and the decode worker's dispatches the
    stream rode (``ticks``, each with its ``tick_seq``, the join key to the
    device statistics' tick rows), emitted once when the stream closes.
    ``record_chunk`` runs on the stream's thread, ``add_tick`` on the decode
    worker's: list appends and attribute stores, atomic under the GIL.  The
    worker also stamps the prefix cache's outcome (``cache_hit_tokens``, the
    deepest matched block's ``prefix_hash``)."""

    __slots__ = ("stride", "token_count", "first_token_ns", "last_token_ns",
                 "ticks", "ticks_dropped", "_writes", "cache_hit_tokens",
                 "prefix_hash")

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.stride = token_event_stride()
        self.token_count = 0
        self.first_token_ns: Optional[int] = None
        self.last_token_ns: Optional[int] = None
        self.ticks: List[Dict[str, int]] = []
        self.ticks_dropped = 0
        self._writes = 0
        self.cache_hit_tokens = 0
        self.prefix_hash: Optional[str] = None

    def add_tick(self, tick: Dict[str, int]) -> None:
        """The decode worker dispatched a tick this stream rode; past
        ``MAX_TICKS_PER_STREAM`` the record keeps the first ones and
        counts the rest."""
        if len(self.ticks) >= MAX_TICKS_PER_STREAM:
            self.ticks_dropped += 1
            return
        self.ticks.append(tick)

    def record_chunk(self, ns: Optional[int] = None) -> int:
        """One streamed response left the core; returns its index."""
        now = int(ns if ns is not None else time.monotonic_ns())
        n = self.token_count
        self.token_count = n + 1
        if n == 0:
            self.first_token_ns = now
            self.ts("FIRST_TOKEN", now)
        elif n % self.stride == 0:
            self.ts(f"TOKEN[{n}]", now)
        self.last_token_ns = now
        return n

    def record_write(self, start_ns: int, end_ns: int) -> None:
        """A frontend wrote one chunk: a NETWORK_WRITE span every
        ``stride`` writes."""
        n = self._writes
        self._writes = n + 1
        if n % self.stride == 0:
            self.add_span("NETWORK_WRITE", start_ns, end_ns)


class _ProfileWindow:
    """A ``torch.profiler`` window on a thread of its own: it starts when
    made and, on :meth:`stop`, ends and writes its Chrome trace into
    ``out_dir`` (``torch.profiler.tensorboard_trace_handler``)."""

    def __init__(self, out_dir: str) -> None:
        self.out_dir = out_dir
        self.error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="trace-profile")
        self._thread.start()
        self._started.wait(timeout=120)

    def _run(self) -> None:
        import torch
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        try:
            with profile(activities=activities,
                         on_trace_ready=tensorboard_trace_handler(
                             self.out_dir)):
                self._started.set()
                self._stop.wait()
        except Exception as e:  # noqa: BLE001 - tracing keeps working
            self.error = e
        finally:
            self._started.set()

    def stop(self, timeout: float = 300.0) -> None:
        self._stop.set()
        self._thread.join(timeout=timeout)


class RequestTracer:
    """Samples requests by the live settings dict and writes the trace
    file.  Holds a reference to ``InferenceCore.trace_settings``, so an
    update applies to the next request; ``settings_updated()`` restarts the
    sampling counters (the reference's per-update ``trace_count``)."""

    def __init__(self, settings: Dict[str, List[str]]) -> None:
        self._settings = settings
        self._lock = threading.Lock()      # sampling counters only
        self._out = AppendFile()
        self._seq = 0          # requests seen since the last update
        self._emitted = 0      # traces emitted since the last update
        self._next_id = 0      # file-unique trace id, never reset
        self._rot_lock = threading.Lock()
        self._rotation: Dict[str, Dict[str, int]] = {}
        self._profile: Optional[_ProfileWindow] = None
        self._profile_lock = threading.Lock()
        self._model_overrides: Dict[str, Dict[str, List[str]]] = {}
        self._model_counters: Dict[str, Dict[str, int]] = {}
        # the core's FlightRecorder: emit() hands it every armed context
        self.flight_recorder = None
        # this process's name in every record (the CLI's --host:--http-port
        # and worker, or TRITON_TPU_REPLICA), and the OTLP exporter of
        # InferenceCore.enable_otlp, which every record is submitted to
        self.replica = ""
        self.otlp = None

    # -- settings ------------------------------------------------------------
    def settings_updated(self) -> None:
        """After a global update: fresh sampling windows everywhere, and the
        profiler window opened or closed by the level."""
        with self._lock:
            self._seq = 0
            self._emitted = 0
            for c in self._model_counters.values():
                c["seq"] = 0
                c["emitted"] = 0
        self._sync_profiler()

    def update_model(self, model_name: str,
                     update: Dict[str, List[str]],
                     cleared: Optional[List[str]] = None) -> None:
        """A model's own settings (validated): values override the global
        scope; ``cleared`` keys inherit it again."""
        with self._lock:
            ov = self._model_overrides.setdefault(model_name, {})
            for k in cleared or []:
                ov.pop(k, None)
            ov.update(update)
            if not ov:
                self._model_overrides.pop(model_name, None)
            self._model_counters[model_name] = {"seq": 0, "emitted": 0}

    def effective_settings(self, model_name: Optional[str]
                           ) -> Dict[str, List[str]]:
        """The settings a model traces under (global merged with its
        own)."""
        with self._lock:
            eff = {k: list(v) for k, v in self._settings.items()}
            for k, v in self._model_overrides.get(model_name, {}).items():
                eff[k] = list(v)
        return eff

    def _sync_profiler(self) -> None:
        want = "PROFILE" in (self._settings.get("trace_level") or [])
        with self._profile_lock:
            if want and self._profile is None:
                self._profile = _ProfileWindow(self._profile_dir())
            elif not want and self._profile is not None:
                window, self._profile = self._profile, None
                window.stop()

    def _profile_dir(self) -> str:
        return self._trace_file() + ".profile"

    def shutdown(self) -> None:
        otlp, self.otlp = self.otlp, None
        if otlp is not None:
            otlp.shutdown()
        self._out.close()
        with self._profile_lock:
            window, self._profile = self._profile, None
        if window is not None:
            window.stop()

    # -- sampling ------------------------------------------------------------
    def _trace_file(self, eff: Optional[Dict[str, List[str]]] = None) -> str:
        vals = (eff if eff is not None
                else self._settings).get("trace_file") or ["trace.json"]
        return vals[0] if vals and vals[0] else "trace.json"

    @staticmethod
    def _eff_int(eff, key, default):
        vals = eff.get(key)
        try:
            return int(vals[0])
        except (TypeError, ValueError, IndexError):
            return default

    def maybe_start(self, model_name: str, model_version: str,
                    client_request_id: str = "",
                    traceparent: str = "",
                    cls: type = TraceContext) -> Optional[TraceContext]:
        """A sampled context for this request, or None (tracing off, not
        this request's turn, or the count spent)."""
        with self._lock:
            ov = self._model_overrides.get(model_name)
            eff = self._settings if ov is None else {**self._settings, **ov}
            levels = eff.get("trace_level") or ["OFF"]
            if "TIMESTAMPS" not in levels:
                return None
            rate = max(1, self._eff_int(eff, "trace_rate", 1000))
            count = self._eff_int(eff, "trace_count", -1)
            if ov is None:
                self._seq += 1
                seq, emitted = self._seq, self._emitted
            else:
                # a model with its own settings samples with its own
                # counters
                c = self._model_counters.setdefault(
                    model_name, {"seq": 0, "emitted": 0})
                c["seq"] += 1
                seq, emitted = c["seq"], c["emitted"]
            if (seq - 1) % rate != 0:
                return None
            if count >= 0 and emitted >= count:
                return None
            if ov is None:
                self._emitted += 1
            else:
                c["emitted"] += 1
            self._next_id += 1
            trace_id = self._next_id
            path = self._trace_file(eff)
            log_frequency = max(0, self._eff_int(eff, "log_frequency", 0))
        return cls(self, trace_id, model_name, model_version, path,
                   client_request_id, traceparent,
                   log_frequency=log_frequency)

    def maybe_start_stream(self, model_name: str, model_version: str,
                           client_request_id: str = "",
                           traceparent: str = ""
                           ) -> Optional[StreamTraceContext]:
        return self.maybe_start(model_name, model_version,
                                client_request_id, traceparent,
                                cls=StreamTraceContext)

    def start_shadow(self, model_name: str, model_version: str,
                     client_request_id: str = "",
                     traceparent: str = "",
                     cls: type = TraceContext) -> TraceContext:
        """An armed, unsampled context for the flight recorder: spans are
        kept, nothing reaches the file, no counter moves."""
        ctx = cls(self, 0, model_name, model_version, "",
                  client_request_id, traceparent)
        ctx.sampled = False
        return ctx

    def start_stream_shadow(self, model_name: str, model_version: str,
                            client_request_id: str = "",
                            traceparent: str = "") -> StreamTraceContext:
        return self.start_shadow(model_name, model_version,
                                 client_request_id, traceparent,
                                 cls=StreamTraceContext)

    def record_refusal(self, model_name: str, *,
                       shed_reason: str = "", status: int = 0,
                       tenant: str = "", protocol: str = "",
                       client_request_id: str = "",
                       traceparent: str = "") -> None:
        """A request refused at admission (429, 413, 503): a minimal record
        with its reason and propagated trace context, so a client's failed
        attempt has a server record.  Nothing where tracing is off; it
        takes no sampling turn (a shed storm must not starve the file of
        the requests it sheds to protect)."""
        if "TIMESTAMPS" not in (self._settings.get("trace_level") or ["OFF"]):
            return
        now = time.monotonic_ns()
        with self._lock:
            self._next_id += 1
            rec_id = self._next_id
            path = self._trace_file()
        record: Dict[str, object] = {
            "id": rec_id,
            "model_name": model_name,
            "model_version": "",
            "timestamps": [{"name": "REFUSED", "ns": now}],
            "spans": [{"name": "REQUEST", "start_ns": now,
                       "end_ns": now, "parent": None}],
            "refused": True,
            "outcome": "shed",
        }
        for key, value in (("shed_reason", shed_reason), ("status", status),
                           ("tenant", tenant), ("protocol", protocol),
                           ("triton_request_id", client_request_id),
                           ("traceparent", traceparent),
                           ("replica", self.replica)):
            if value:
                record[key] = value
        self._export(record)
        self._out.append(path, json.dumps(record) + "\n")

    def _export(self, record: Dict[str, object]) -> None:
        otlp = self.otlp
        if otlp is not None:
            otlp.submit(record)  # never blocks: queued or dropped

    def _emit(self, ctx: TraceContext) -> None:
        record = {
            "id": ctx.id,
            "model_name": ctx.model_name,
            "model_version": ctx.model_version,
            "timestamps": ctx.timestamps,
        }
        if ctx.spans:
            record["spans"] = [
                {"name": s.name, "start_ns": s.start_ns,
                 "end_ns": s.end_ns if s.end_ns is not None else s.start_ns,
                 "parent": s.parent,
                 **({"attrs": s.attrs} if s.attrs else {})}
                for s in ctx.spans]
        if ctx.tick is not None:
            record["tick"] = ctx.tick
        if ctx.cost is not None:
            record["cost"] = ctx.cost
        if isinstance(ctx, StreamTraceContext):
            record["tokens"] = ctx.token_count
            record["outcome"] = ctx.outcome
            record["cache_hit_tokens"] = ctx.cache_hit_tokens
            record["prefix_hash"] = ctx.prefix_hash
            if ctx.ticks:
                record["ticks"] = ctx.ticks
            if ctx.ticks_dropped:
                record["ticks_dropped"] = ctx.ticks_dropped
        if ctx.client_request_id:
            record["triton_request_id"] = ctx.client_request_id
        if ctx.traceparent:
            record["traceparent"] = ctx.traceparent
        if self.replica:
            record["replica"] = self.replica
        self._export(record)
        # an unwritable trace_file never fails the request (AppendFile
        # drops the write)
        self._out.append(self._rotated_path(ctx), json.dumps(record) + "\n")

    def _rotated_path(self, ctx: TraceContext) -> str:
        """``path`` where ``log_frequency`` is 0, else ``<path>.<index>``,
        the index moving on every ``log_frequency`` traces."""
        if ctx.log_frequency <= 0:
            return ctx.path
        with self._rot_lock:
            st = self._rotation.setdefault(ctx.path, {"count": 0, "index": 0})
            if st["count"] >= ctx.log_frequency:
                st["index"] += 1
                st["count"] = 0
            st["count"] += 1
            return f"{ctx.path}.{st['index']}"
